"""The port's architecture registry equals the JAX package's, field by
field, for every architecture and its smoke variant."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402


def test_arch_lists_identical():
    assert TC.ARCHS == JC.ARCHS
    assert TC.ASSIGNED == JC.ASSIGNED


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", JC.ARCHS)
def test_config_fields_identical(arch, smoke):
    get_j = JC.get_smoke if smoke else JC.get
    get_t = TC.get_smoke if smoke else TC.get
    j, t = get_j(arch), get_t(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.padded_heads, t.padded_vocab, t.param_count(),
            t.active_param_count()) == \
        (j.padded_heads, j.padded_vocab, j.param_count(),
         j.active_param_count())
    assert t.torch_dtype == getattr(torch, j.dtype)
    assert str(j.jnp_dtype) == str(t.torch_dtype).removeprefix("torch.")
