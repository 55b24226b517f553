"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's, and its own invariants.

  * argument and output bytes: the smoke cells of the dense family's
    three step kinds, MoE decode (``ep``) and ssm decode, traced on a
    fake (2, 4) mesh, give the reference's
    ``compile_cell(...).memory_analysis()`` on an 8-device JAX mesh;
  * the 1-/2-unit extrapolation equals the full-depth count (the port
    has no scan, so its full-depth trace is exact);
  * one full-width cell (llama3-8b decode_32k on the 16 x 16 pod)
    traces, with the K/V cache gathered for K1 on every layer;
  * ``--all``'s skips are the reference's ``cell_is_defined``.

The reference's ``dryrun`` sets ``XLA_FLAGS`` to 512 devices at import,
which would leak into every later test of a pytest worker, so it is
imported only in a subprocess whose JAX backend is already up at 8
devices; every process group (here the fake one) lives in a subprocess
too (``_torch_dist``).
"""
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_dist import result, run  # noqa: E402

CELLS = [("llama3_8b", "train_4k"), ("llama3_8b", "prefill_32k"),
         ("llama3_8b", "decode_32k"), ("gpt_oss_20b", "decode_32k"),
         ("rwkv6_3b", "decode_32k")]


def port_bytes() -> dict:
    """The port's memory record of each smoke cell on a fake (2, 4) mesh,
    and the 1-/2-unit extrapolation of the dense decode cell."""
    from _torch_dist import checks
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as ML
    from repro_torch.launch import steps as S

    def cell_bytes(arch, shape):
        def fn():
            tr, tensors, _ = D.compile_cell(S.get_cell(arch, shape,
                                                       smoke=True),
                                            mesh, device="cpu")
            return D.analyze_compiled(tr, tensors)["memory"]
        return fn

    def extrapolation():
        cell = S.get_cell("llama3_8b", "decode_32k", smoke=True)
        tr, tensors, _ = D.compile_cell(cell, mesh, device="cpu")
        full = D.analyze_compiled(tr, tensors)
        ext = D.extrapolate_roofline(cell, mesh, device="cpu")
        return (full["cost"]["flops"], full["cost"]["bytes"],
                full["collectives"]["per_chip_bytes"],
                full["collectives"]["by_op"]), \
            (ext["flops"], ext["bytes"], ext["collective_per_chip_bytes"],
             ext["collective_by_op"])
    with ML.fake_world(8):
        mesh = ML.make_mesh((2, 4), ("data", "model"), device_type="cpu")
        return checks([(f"{a}.{s}", cell_bytes(a, s)) for a, s in CELLS]
                      + [("extrapolation", extrapolation)])


def reference_bytes() -> dict:
    """The reference's argument and output bytes of each smoke cell on an
    8-device (2, 4) JAX mesh."""
    import jax
    assert len(jax.devices()) == 8      # before the import sets XLA_FLAGS
    from repro.launch import dryrun as RD
    from repro.launch import steps as RS
    from repro.launch.mesh import make_mesh
    jmesh = make_mesh((2, 4), ("data", "model"))
    out = {}
    for arch, shape in CELLS:
        compiled, _, _ = RD.compile_cell(RS.get_cell(arch, shape, smoke=True),
                                         jmesh)
        ma = compiled.memory_analysis()
        out[f"{arch}.{shape}"] = (ma.argument_size_in_bytes,
                                  ma.output_size_in_bytes,
                                  compiled.out_tree.num_leaves)
    return out


@pytest.fixture(scope="module")
def records():
    port = run("""
    from _torch_dist import save
    import test_torch_dryrun as T
    save(OUT, T.port_bytes())
    """, timeout=600)
    ref = run("""
    from _torch_dist import save
    import test_torch_dryrun as T
    save(OUT, T.reference_bytes())
    """, jax_devices=8, timeout=600)
    return port, ref


@pytest.mark.parametrize("cell", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_argument_and_output_bytes_match_reference(records, cell):
    port, ref = records
    mem = result(port, ".".join(cell))
    want_args, want_out, n_out = ref[".".join(cell)]
    assert mem["argument_bytes"] == want_args, (mem, want_args)
    # XLA's output size also holds the output tuple's table, one 8-byte
    # pointer per leaf; no scalar leaf's dtype differs (the AdamW step
    # int32, the loss fp32, on both sides)
    assert mem["output_bytes"] == want_out - 8 * n_out, (mem, want_out)
    assert 0 < mem["alias_bytes"] <= mem["output_bytes"]
    assert mem["temp_bytes"] > 0


def test_extrapolation_equals_full_depth(records):
    full, ext = result(records[0], "extrapolation")
    assert full[:3] == ext[:3]
    assert full[3].keys() == {k for k, v in ext[3].items() if v}
    for k, v in full[3].items():
        assert ext[3][k] == v


def test_full_width_cell_traces():
    rec = run("""
    import json
    from _torch_dist import save
    from repro_torch.launch import dryrun as D
    save(OUT, D.run_cell("llama3_8b", "decode_32k", "pod1",
                         with_extrapolation=False, device="cpu"))
    """, timeout=600)
    assert rec["ok"] and rec["devices"] == 256, rec.get("error")
    # the cache (K and V, 32 layers, B 128, T 32768, 8 KV heads of 128,
    # bf16) written in place: B over data, T over model, 1/256 a chip;
    # K1 gathers each layer's K/V (2 x 32 all-gathers)
    mem = rec["memory"]
    assert mem["alias_bytes"] == 2 * 32 * 128 * 32768 * 8 * 128 * 2 // 256
    assert rec["collectives"]["counts"]["all-gather"] >= 64
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes"] > 0
    json.dumps(rec)


def test_all_skips_are_the_references():
    out = run("""
    from _torch_dist import save
    from repro.launch.steps import cell_is_defined as ref
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.steps import cell_is_defined
    from repro_torch.models.config import SHAPES
    import repro_torch.configs as C
    save(OUT, [(a, s, cell_is_defined(a, s), ref(a, s))
               for a in C.ASSIGNED for s in SHAPES])
    """)
    assert len(out) == 40
    for a, s, got, want in out:
        assert got == want, (a, s)
