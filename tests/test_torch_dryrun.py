"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's, and its own invariants.

  * argument and output bytes: the smoke cells of the dense family's
    three step kinds, MoE decode (``ep``) and ssm decode, traced on a
    fake (2, 4) mesh, give the reference's
    ``compile_cell(...).memory_analysis()`` on an 8-device JAX mesh;
  * collectives by op kind on the same mesh, against the reference's
    1-/2-unit extrapolation, in the cells where the reference's record
    is self-consistent (``consistent``);
  * the 1-/2-unit extrapolation equals the full-depth count (the port
    has no scan, so its full-depth trace is exact);
  * one full-width cell (llama3-8b decode_32k on the 16 x 16 pod)
    traces with its K/V cache left sharded over T: no all-gather of the
    cache, and per-chip collective bytes within 4x of the reference's,
    run live;
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
# the cells whose reference record is self-consistent (``consistent``)
CONSISTENT = [("llama3_8b", "decode_32k"), ("gpt_oss_20b", "decode_32k")]
RATIO = (0.25, 4.0)         # port / reference collective bytes


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
            rec = D.analyze_compiled(tr, tensors)
            return rec["memory"], rec["collectives"]["by_op"]
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
    8-device (2, 4) JAX mesh, with its collectives: the scanned step's
    and the 1-/2-unit extrapolation's."""
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
        ext = RD.extrapolate_roofline(RS.get_cell(arch, shape, smoke=True),
                                      jmesh)
        out[f"{arch}.{shape}"] = (ma.argument_size_in_bytes,
                                  ma.output_size_in_bytes,
                                  compiled.out_tree.num_leaves,
                                  RD.analyze_compiled(compiled)[
                                      "collectives"], ext)
    return out


def consistent(full: dict, ext: dict) -> bool:
    """Whether the reference's collective record of a cell holds
    together: its scanned step, whose layer body XLA counts once, counts
    what its 1-unit variant does, and its 2-unit variant adds, per op
    kind, no negative bytes and no kind the 1-unit one lacks."""
    one = ext["unit1"]["coll"]
    kinds = {k for k, v in full["by_op"].items() if v}
    return full["per_chip_bytes"] == one and all(
        v >= full["by_op"].get(k, 0.0) if k in kinds else not v
        for k, v in ext["collective_by_op"].items())


def within(port: float, ref: float) -> bool:
    return RATIO[0] * ref <= port <= RATIO[1] * ref


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
    mem, _ = result(port, ".".join(cell))
    want_args, want_out, n_out = ref[".".join(cell)][:3]
    assert mem["argument_bytes"] == want_args, (mem, want_args)
    # XLA's output size also holds the output tuple's table, one 8-byte
    # pointer per leaf; no scalar leaf's dtype differs (the AdamW step
    # int32, the loss fp32, on both sides)
    assert mem["output_bytes"] == want_out - 8 * n_out, (mem, want_out)
    assert 0 < mem["alias_bytes"] <= mem["output_bytes"]
    assert mem["temp_bytes"] > 0


@pytest.mark.parametrize("cell", CONSISTENT,
                         ids=[f"{a}-{s}" for a, s in CONSISTENT])
def test_collectives_by_op_match_reference(records, cell):
    """Per chip, by op kind: the port records no kind the reference
    lacks, and each kind it records, and the total, within 4x of the
    reference's extrapolation (the reference moves some of gpt-oss-20b's
    expert traffic by all-to-all, which the port does by all-gather)."""
    port, ref = records
    _, by_op = result(port, ".".join(cell))
    full, ext = ref[".".join(cell)][3:]
    assert consistent(full, ext)
    want = {k: v for k, v in ext["collective_by_op"].items() if v}
    got = {k: v for k, v in by_op.items() if v}
    assert got and set(got) <= set(want), (got, want)
    for k, v in got.items():
        assert within(v, want[k]), (k, got, want)
    assert within(sum(got.values()), sum(want.values())), (got, want)


def test_only_the_compared_cells_are_self_consistent(records):
    """The cells left out of the comparison are those whose reference
    record does not hold together: train_4k's scanned step counts more
    than its 1-unit variant, prefill_32k's 2-unit variant drops the
    all-gather and adds kinds, rwkv6-3b's scanned decode counts more
    than its 1-unit one."""
    _, ref = records
    got = [cell for cell in CELLS
           if consistent(*ref[".".join(cell)][3:])]
    assert got == CONSISTENT


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
    ref = run("""
    from repro.launch import dryrun as RD      # sets 512 devices first
    from _torch_dist import save
    rec = RD.run_cell("llama3_8b", "decode_32k", "pod1")
    save(OUT, rec["extrapolated"]["collective_per_chip_bytes"])
    """, jax_devices=512, timeout=600)
    assert rec["ok"] and rec["devices"] == 256, rec.get("error")
    # the cache (K and V, 32 layers, B 128, T 32768, 8 KV heads of 128,
    # bf16) written in place: B over data, T over model, 1/256 a chip
    mem = rec["memory"]
    cache = 2 * 32 * 128 * 32768 * 8 * 128 * 2
    assert mem["alias_bytes"] == cache // 256
    # K1 attends over each rank's T shard and the shards are merged by
    # all-reduces: the cache is never gathered (gathering it took 2 x 32
    # all-gathers of a 16th of it a chip, 34,359.7 MB)
    coll = rec["collectives"]
    assert coll["by_op"].get("all-gather", 0.0) < 0.01 * cache // 16
    assert within(coll["per_chip_bytes"], ref), (coll, ref)
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
