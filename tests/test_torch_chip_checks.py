"""chip_smoke.py's check of a flash kernel output against its plain version,
and flash_mutants.py's mutations, on the CPU: the check passes rounding at
its dtype's level and rejects a small bias and a wrong row, and every
mutation still finds the one place it breaks in the current source. Also
the ring block check (kernel 2's o, m, l, with exact rows where no key is
visible; the head widths where it holds a bf16 kernel's rounding of P),
the work counted for a block's bound, the logit comparison of
the ring phase, the SASS build check of the sm90 templates and of kernel
1's bulk-copy kernels and of the scheduler's kernels, the paged sweep's
shapes and lengths, and the scheduler phases' helpers: the bytes a tick or
a drive moves, the tick counts the card must reproduce, the seeded gang
batch and its oracle check; and the runtime phase's helpers: the assign
oracle's agreement rule and replay, the crossover snapshots and verdict,
the recorder's timing summary and assign's bytes; and the serve phase's
helpers: the quantile rule (Serve's own), TTFT and latency of a stream,
a round's summary, kernel 1's launch rule on the Serve path, and the
greedy-parity near-tie rule it shares with phase parity; and phase moe's
dropped share a layer; and the multinode phase's leaf, which a worker of
the machine about to die runs without leaving its mark."""

import json
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import chip_smoke  # noqa: E402
import flash_mutants  # noqa: E402


def _output(seed=0):
    """[64 rows, 128] values whose rows differ in scale, as o's rows do."""
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(np.arange(1, 65))[:, None]
    return torch.from_numpy((rng.normal(size=(64, 128)) * scale)
                            .astype(np.float32))


def _case(name, want):
    if name == "bf16_rounding":
        return want.to(torch.bfloat16).float()
    if name == "bias_1pct":
        return want * 1.01
    if name == "one_row_wrong":
        got = want.clone()
        got[40] += 0.1 * want[40].square().mean().sqrt()
        return got
    assert name == "zero_row"
    want[0] = 0
    got = want.to(torch.bfloat16).float()
    got[0] = 1e-9
    return got


@pytest.mark.parametrize("name, ok", [
    ("bf16_rounding", True), ("bias_1pct", False), ("one_row_wrong", False),
    ("zero_row", True)])
def test_bf16_output_check(name, ok):
    want = _output()
    got = _case(name, want)
    r = chip_smoke._reading(torch, "o", got, want,
                            chip_smoke.FLASH_BOUNDS["bfloat16"])
    assert np.isfinite(r["err_over_bound"])
    assert r["ok"] is ok, r


@pytest.mark.parametrize("name", [n for n, m in flash_mutants.MUTANTS.items()
                                  if m[1] is not None])
def test_mutation_applies_once(name):
    _what, rel, text, _repl = flash_mutants.MUTANTS[name]
    source = (Path(flash_mutants.__file__).parent / rel).read_text()
    assert source.count(text) == 1


def _block(seed=0, q_offset=0, k_offset=0, causal=True):
    """The plain ring block's (o, m, l) on a small GQA block."""
    from ray_tpu_torch.ops import ring_attention as ra

    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((1, 4, 48, 128), (1, 2, 40, 128), (1, 2, 40, 128)))
    return ra._block_attention_reference(q, k, v, q_offset, k_offset, causal)


def _ring_case(name):
    """(kernel outputs, plain outputs) for a named case: offsets 5, 20 leave
    the first 15 query rows without a visible key."""
    from ray_tpu_torch.ops import ring_attention as ra

    want = _block(q_offset=5, k_offset=20)
    o, m, l = (t.clone() for t in want)
    if name == "bf16_rounding":
        o = o.to(torch.bfloat16).float()
    elif name == "dead_row_live":
        o[0, 0, 3] = 1e-3
    elif name == "dead_row_m":
        m[0, 1, 0] = 0.0
    elif name == "m_shift":
        m[0, 2, 30] += 1e-3
    elif name == "l_low":
        l = l * (1 - 1e-5)
    elif name == "masked_exact":
        want = _block(q_offset=0, k_offset=1000)
        o, m, l = (t.clone() for t in want)
    elif name == "masked_not_zero":
        want = _block(q_offset=0, k_offset=1000)
        o, m, l = (t.clone() for t in want)
        l[0, 0, 0] = 1.0
    else:
        assert name == "exact"
    assert bool((want[1] == ra.NEG_INF).any())
    return (o, m, l), want


@pytest.mark.parametrize("name, ok", [
    ("exact", True), ("bf16_rounding", True), ("dead_row_live", False),
    ("dead_row_m", False), ("m_shift", False), ("l_low", False),
    ("masked_exact", True), ("masked_not_zero", False)])
def test_ring_block_check(name, ok):
    from ray_tpu_torch.ops import ring_attention as ra

    got, want = _ring_case(name)
    r = chip_smoke.ring_block_check(torch, "bfloat16", got, want, ra.NEG_INF)
    assert all(np.isfinite(x["err_over_bound"]) for x in r["outputs"])
    assert r["dead_rows"] > 0
    assert r["ok"] is ok, r


def _bf16_p_block(D, label, seed=0):
    """(outputs, plain outputs) of kernel 2 in bf16 emulated on the CPU on
    one of RING_SMALL's blocks at head_dim D: the plain version's o with P
    rounded to bf16 before P v, the one rounding the kernel makes by
    design, and its m and l."""
    from ray_tpu_torch.ops import ring_attention as ra

    h, kv, tq, tk, q_off, k_off, causal = chip_smoke.RING_SMALL[label]
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(chip_smoke.RING_SMALL_BATCH,
                                                 n, t, D)).astype(np.float32))
               .bfloat16().float() for n, t in ((h, tq), (kv, tk), (kv, tk)))
    want = ra._block_attention_reference(q, k, v, q_off, k_off, causal)
    k, v = (t.repeat_interleave(h // kv, 1) for t in (k, v))
    s = q @ k.transpose(-1, -2) / D ** 0.5
    if causal:
        s = s.masked_fill(torch.arange(tk) + k_off
                          > torch.arange(tq)[:, None] + q_off, float("-inf"))
    p = torch.exp(s - want[1][..., None]).nan_to_num(0.0)
    return (p.bfloat16().float() @ v, want[1], want[2]), want


@pytest.mark.parametrize("D", [3, 8, *chip_smoke.RING_PADDED["bfloat16"]])
@pytest.mark.parametrize("label", list(chip_smoke.RING_SMALL))
def test_ring_bf16_bound_holds_p_rounding_from_head_dim_8(D, label):
    """Why phase ring_kernel holds bf16 at RING_PADDED's bf16 widths and at
    8 and up, not at 3: a kernel whose one error is P in bf16 is inside
    FLASH_BOUNDS on every output there, and at 3 only its rel L2 is (the
    element-wise bound over a row of 3 values is out of reach)."""
    from ray_tpu_torch.ops import ring_attention as ra

    got, want = _bf16_p_block(D, label)
    r = chip_smoke.ring_block_check(torch, "bfloat16", got, want, ra.NEG_INF)
    o = r["outputs"][0]
    assert o["rel_l2"] <= o["rel_l2_bound"] / 4, o
    assert r["ok"] is (D >= 8), o


@pytest.mark.parametrize("q_offset, k_offset, causal, pairs", [
    (8, 8, True, 8 * 9 // 2),          # diagonal: T(T+1)/2
    (16, 0, True, 64),                 # below: every key
    (0, 8, True, 0),                   # above: none
    (3, 0, True, 4 + 5 + 6 + 7 + 8 + 8 + 8 + 8),
    (0, 8, False, 64)])
def test_ring_block_work_counts_visible_pairs(q_offset, k_offset, causal,
                                              pairs):
    B, H, KV, T, D = 1, 4, 2, 8, chip_smoke.FLASH_D
    nbytes, flops = chip_smoke._ring_block_work(B, H, KV, T, T, q_offset,
                                                k_offset, causal, 2)
    assert flops == 4 * D * B * H * pairs
    out_bytes = B * H * T * (D + 2) * 4
    in_bytes = (B * H * T + 2 * B * KV * T) * D * 2
    assert nbytes == out_bytes + (in_bytes if pairs else 0)


def test_ring_path_block_bounds():
    """The ring phase's blocks at the path's shapes: 2.75e11 and 5.50e11
    flops, and outputs only for the block that sees no key."""
    H, KV, T = chip_smoke.TRAIN["n_heads"], chip_smoke.TRAIN["n_kv_heads"], \
        chip_smoke.RING_T
    work = {label: chip_smoke._ring_block_work(1, H, KV, T, T, qo, ko, True,
                                               2)
            for label, (qo, ko) in chip_smoke.RING_BLOCKS.items()}
    assert work["diagonal"][1] == 4 * 128 * H * T * (T + 1) // 2
    assert work["full"][1] == 4 * 128 * H * T * T
    assert work["masked"] == (H * T * 130 * 4, 0)


def test_ring_kernel_checks_each_path_shape():
    """Phase ring_kernel holds kernel 2 at each width on the blocks that
    width's ring forward in phase ring gives it: the configuration's heads
    over its sequence cut in RING_SHARDS shards."""
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.ops import head_dims

    shapes = chip_smoke.ring_path_shapes()
    assert set(shapes) == set(head_dims.BLOCK_ATTENTION)
    paths = {128: (chip_smoke.TRAIN, chip_smoke.RING_SEQ),
             64: (chip_smoke.DEFAULT, chip_smoke.DEFAULT_RING_SEQ),
             **{D: (fields, chip_smoke.WIDTH_RING_SEQ)
                for D, fields in chip_smoke.width_models().items()}}
    assert set(paths) == set(shapes)
    for D, (fields, seq) in paths.items():
        cfg = TransformerConfig(**fields)
        assert cfg.head_dim == D
        assert shapes[D] == (cfg.n_heads, cfg.n_kv_heads,
                             seq // chip_smoke.RING_SHARDS)
    assert chip_smoke.RING_BLOCKS == chip_smoke.ring_blocks(chip_smoke.RING_T)


def test_logit_diff():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.normal(size=(1, 2500, 16)).astype(np.float32))
    same = chip_smoke._logit_diff(torch, a, a.clone())
    assert same["rel_l2"] == 0.0 and same["argmax_agree"] == 1.0
    b = a.clone()
    b[0, 2100] *= 2.0
    d = chip_smoke._logit_diff(torch, b, a)
    want = float((b - a).norm() / a.norm())
    assert abs(d["rel_l2"] - want) < 1e-6 * want
    assert d["max_abs_err"] == float((b - a).abs().max())


def _sass(*funcs):
    """cuobjdump -sass text: one "Function : name" section per (name,
    body)."""
    return "".join(f"\tFunction : {name}\n{body}\n" for name, body in funcs)


_BWD_DQ = "_ZN3sm9023attention_bwd_dq_kernelILb1EEEv"
_BWD_DKV = "_ZN3sm9024attention_bwd_dkv_kernelILb1EEEv"


@pytest.mark.parametrize("case, problems", [
    ("sound", []),
    ("no_hgmma", ["instances without HGMMA/UTMALDG"]),
    ("spills", ["instances spill 8 bytes"]),
    ("few_registers", ["registers [128] (need 168)"]),
    ("missing", ["instances without HGMMA/UTMALDG", "registers [] (need 168)"]),
])
def test_sm90_instances(case, problems):
    """The build check of one sm90 template's instances in a library: the
    backward's dQ instance must carry HGMMA and UTMALDG, no spills and the
    registers the setmaxnreg split needs; the dK/dV instance beside it is
    not counted as dQ's."""
    body = "UTMALDG.4D [UR8] ;\nHGMMA.64x128x16.F32.BF16 R24 ;"
    regs, spill = 168, 0
    if case == "no_hgmma":
        body = "UTMALDG.4D [UR8] ;"
    elif case == "spills":
        spill = 8
    elif case == "few_registers":
        regs = 128
    funcs = [(_BWD_DKV, "HGMMA UTMALDG")]
    report = {"attention_bwd_dkv_kernel<true>": "Used 168 registers"}
    if case != "missing":
        funcs.append((_BWD_DQ, body))
        report["attention_bwd_dq_kernel<true>"] = (
            f"0 bytes stack frame, {spill} bytes spill stores, 0 bytes "
            f"spill loads; Used {regs} registers, used 1 barriers")
    log = "ptxas warning : setmaxnreg ignored" if case == "few_registers" else ""
    row, found = chip_smoke.sm90_instances(
        "attention_bwd_dq_kernel", _sass(*funcs), report, log)
    assert [p.split(": ", 1)[1] for p in found] == problems
    assert row["instances"] == (0 if case == "missing" else 1)
    assert len(row["ptxas_warnings"]) == (case == "few_registers")


def test_kernel_2_is_build_checked_at_every_width():
    """Phase build_sm90 holds kernel 2's library at every width to the
    split kernel's instances (HGMMA, UTMALDG, no spills; no register floor:
    no setmaxnreg), and at 64 and 256 also to the 128-query template's (128
    is SM90_KERNELS'): the 16 and 32 libraries by themselves."""
    from ray_tpu_torch.ops import head_dims

    checks = chip_smoke.width_build_checks()
    ring = {(lib, kernel): how for lib, kernel, how in checks
            if lib.startswith("ring_attention")}
    want = {}
    for D in head_dims.BLOCK_ATTENTION:
        lib = head_dims.library("ring_attention", D)
        want[(lib, chip_smoke.SPLIT_KERNEL)] = {"min_registers": None}
        if D in (64, 256):
            want[(lib, "attention_fwd_kernel")] = {}
    assert ring == want
    assert chip_smoke.SM90_KERNELS["ring_attention"] == (
        "attention_fwd_kernel",)
    name = ("_ZN3sm9026attention_fwd_split_kernelILb1ELi16EN12_GLOBAL__N_1"
            "12RingBlockOutILi16EEEEEvv")
    report = {"attention_fwd_split_kernel<true, 16, RingBlockOut<16> >":
              "0 bytes spill stores, 0 bytes spill loads; Used 132 registers"}
    row, found = chip_smoke.sm90_instances(
        chip_smoke.SPLIT_KERNEL, _sass((name, "UTMALDG.4D ;\nHGMMA.64x128x16 ;")),
        report, "", min_registers=None)
    assert found == [] and row["instances"] == 1
    # the template's name does not match the split kernel's
    row, found = chip_smoke.sm90_instances(
        "attention_fwd_kernel", _sass((name, "HGMMA UTMALDG")), report, "")
    assert row["instances"] == 0 and found


def test_every_flash_kernel_is_checked_as_sm90():
    assert chip_smoke.SM90_KERNELS["flash_attention"] == (
        "attention_fwd_kernel", "attention_bwd_dq_kernel",
        "attention_bwd_dkv_kernel")
    assert chip_smoke.SM90_MIN_REGISTERS == 168


def test_the_256_backward_is_build_checked_as_sm90():
    """The head_dim-256 flash library's build check holds its forward and
    both backward kernels (3c, 3b) to HGMMA and UTMALDG, no spills and
    the registers of the setmaxnreg split: their warpgroups split as the
    128 instances' do (two consumers at 240, a producer at 24), so the
    same floor, 168."""
    checks = chip_smoke.width_build_checks()
    d256 = [(kernel, how) for lib, kernel, how in checks
            if lib == "flash_attention_d256"]
    assert d256 == [("attention_fwd_kernel", {}),
                    ("attention_bwd_dq_kernel", {}),
                    ("attention_bwd_dkv_kernel", {})]
    body = "UTMALDG.4D [UR8] ;\nHGMMA.64x64x16.F32.BF16 R24 ;"
    report = {"attention_bwd_dkv_kernel<true>": (
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads; "
        "Used 168 registers, used 3 barriers")}
    row, found = chip_smoke.sm90_instances(
        "attention_bwd_dkv_kernel", _sass((_BWD_DKV, body)), report, "")
    assert found == [] and row["hgmma"] and row["utmaldg"]
    report["attention_bwd_dkv_kernel<true>"] = "Used 160 registers"
    _row, found = chip_smoke.sm90_instances(
        "attention_bwd_dkv_kernel", _sass((_BWD_DKV, body)), report, "")
    assert found == ["attention_bwd_dkv_kernel: registers [160] (need 168)"]


@pytest.mark.parametrize("name, group", [
    ("void (anonymous namespace)::sm90::attention_bwd_dq_kernel<true>"
     "(CUtensorMap_st, CUtensorMap_st)", "flash attention"),
    ("void (anonymous namespace)::sm90::attention_bwd_dkv_kernel<true>"
     "(CUtensorMap_st)", "flash attention"),
    ("void (anonymous namespace)::sm90::attention_fwd_kernel<true, "
     "(anonymous namespace)::FlashFwdOut>(CUtensorMap_st)", "flash attention"),
    ("void (anonymous namespace)::flash_bwd_dq_kernel<float, true>(float "
     "const*)", "flash attention"),
    ("void (anonymous namespace)::sm90::attention_fwd_kernel<true, "
     "(anonymous namespace)::RingBlockOut>(CUtensorMap_st)", "ring attention"),
    ("void (anonymous namespace)::paged_decode_split_kernel<__nv_bfloat16, "
     "2>(__nv_bfloat16 const*)", "paged attention"),
    ("(anonymous namespace)::paged_decode_merge_kernel(float const*, "
     "float*, int, int)", "paged attention"),
    ("nvjet_hsh_256x128_64x4_1x2_h_bz_coopA_NTT", "matrix products"),
    ("(anonymous namespace)::sched_plan_kernel(int*, int*, float const*)",
     "scheduler"),
    ("void at::native::elementwise_kernel<128, 2>", "other")])
def test_kernel_group(name, group):
    assert chip_smoke.kernel_group(name) == group


_ANON = "_ZN51_GLOBAL__N__e929ddf8_18_paged_attention_cu_ad584a0a"
_SPLIT = _ANON + "25paged_decode_split_kernelIfLi2EEEv"
_MERGE = _ANON + "25paged_decode_merge_kernelEPKfPfii"


@pytest.mark.parametrize("case, problems", [
    ("sound", []),
    ("no_bulk_copy", ["instances without UBLKCP"]),
    ("spills", ["instances spill 4 bytes"]),
    ("missing", ["instances without UBLKCP"]),
])
def test_bulk_kernel_instances(case, problems):
    """Kernel 1's split kernel: UBLKCP (cp.async.bulk) in every instance's
    SASS and no spills; its registers are not held to the sm90 templates'
    setmaxnreg floor."""
    body = ("SYNCS.EXCH.64 URZ, [UR4], UR6 ;\nUBLKCP.S.G [UR8], [UR10], UR12 ;"
            if case != "no_bulk_copy" else "LDG.E.128 R4, [R2.64] ;")
    spill = 4 if case == "spills" else 0
    funcs = [(_MERGE, "LDG.E R2, [R4.64] ;")]
    report = {"paged_decode_merge_kernel": "Used 32 registers"}
    if case != "missing":
        funcs.append((_SPLIT, body))
        report["paged_decode_split_kernel<float, 2>"] = (
            f"0 bytes stack frame, {spill} bytes spill stores, 0 bytes "
            f"spill loads; Used 48 registers, used 1 barriers")
    row, found = chip_smoke.sm90_instances(
        "paged_decode_split_kernel", _sass(*funcs), report, "",
        ops=("UBLKCP",), min_registers=None)
    assert [p.split(": ", 1)[1] for p in found] == problems
    assert row["instances"] == (0 if case == "missing" else 1)
    assert row["ublkcp"] is (case != "no_bulk_copy")
    assert "hgmma" not in row


def test_merge_kernel_needs_only_an_instance_without_spills():
    row, found = chip_smoke.sm90_instances(
        "paged_decode_merge_kernel", _sass((_MERGE, "LDG.E R2 ;")),
        {"paged_decode_merge_kernel": "0 bytes spill stores; Used 32 "
                                      "registers"}, "", ops=(),
        min_registers=None)
    assert found == [] and row["instances"] == 1
    _row, found = chip_smoke.sm90_instances(
        "paged_decode_merge_kernel", _sass((_SPLIT, "UBLKCP")), {}, "",
        ops=(), min_registers=None)
    assert found == ["paged_decode_merge_kernel: no instances"]


def test_paged_kernels_are_build_checked():
    assert chip_smoke.BULK_KERNELS == {"paged_attention": {
        "paged_decode_split_kernel": ("UBLKCP",),
        "paged_decode_merge_kernel": ()}}


@pytest.mark.parametrize("page, pps, MP", [(8, 2, 16), (16, 3, 7),
                                           (32, 16, 16)])
def test_paged_lengths_cut_every_edge(page, pps, MP):
    """The card sweep's lengths: empty, one token, a page and one past,
    a split and one past, the table and past it; eight sequences."""
    lens = chip_smoke.paged_lengths(page, pps, MP)
    assert len(lens) == 8 and lens[0] == 0 and lens[1] == 1
    assert {page, page + 1, pps * page, pps * page + 1} <= set(lens)
    assert max(lens) > MP * page


def test_paged_sweep_covers_every_group_and_page():
    sweep = chip_smoke.PAGED_SWEEP
    assert {g for g, _p, _m in sweep} == {1, 2, 4, 8}
    # 4: the serving A/B's page (chip_smoke phase perf)
    assert {p for _g, p, _m in sweep} == {4, 8, 16, 32}
    # 16 and a count of pages that 2 and 3 pages per split do not divide
    assert {m for _g, _p, m in sweep} == {16, 7}
    assert chip_smoke.PAGED_TOL == 1e-4


def test_mutant_summary_reads_paged_rows():
    out = "\n".join(json.dumps(r) for r in (
        {"phase": "kernel", "name": "paged_decode_attention",
         "shape": "sweep", "cases": 178, "max_abs_err": 0.3,
         "failed": [{"err": 0.3}], "ok": False},
        {"phase": "kernel", "name": "paged_decode_attention",
         "shape": "serving", "dtype": "bfloat16", "max_abs_err": 0.2,
         "deterministic": True, "graph_bit_identical": True},
        {"verdict": {"paged_kernel": "rejected: x", "kernel": "passed"}}))
    row = flash_mutants.summary("paged_tail", out)
    assert row["paged_kernel"] == {
        "sweep": {"max_abs_err": 0.3, "failed": 1},
        "serving bfloat16": {"max_abs_err": 0.2, "deterministic": True,
                             "graph_bit_identical": True}}
    assert row["verdict"]["paged_kernel"].startswith("rejected")


# ----------------------------------------------------------------------
# the scheduler phases (sched_kernel, north_star)
# ----------------------------------------------------------------------

def test_scheduler_kernels_are_build_checked():
    """Every kernel of csrc/scheduler_tick.cu is in the build check, which
    asks each for an instance and no spills (no wgmma, no TMA)."""
    src = (Path(chip_smoke.__file__).parent / "ray_tpu_torch" / "ops"
           / "csrc" / "scheduler_tick.cu").read_text()
    kernels = chip_smoke.SCHED_KERNELS["scheduler_tick"]
    assert list(chip_smoke.SCHED_KERNELS) == ["scheduler_tick"]
    assert sorted(kernels) == sorted(re.findall(
        r"__global__ void __launch_bounds__\([^)]*\) (\w+)\(", src))
    assert all(ops == () for ops in kernels.values())


@pytest.mark.parametrize("spill, problems", [
    (0, []), (12, ["sched_plan_kernel: instances spill 12 bytes"])])
def test_scheduler_kernel_spills_are_refused(spill, problems):
    name = "_ZN27_GLOBAL__N__scheduler_tick17sched_plan_kernelEPiS0_"
    _row, found = chip_smoke.sm90_instances(
        "sched_plan_kernel", _sass((name, "BAR.SYNC.DEFER_BLOCKING 0x0 ;")),
        {"sched_plan_kernel": f"8 bytes stack frame, {spill} bytes spill "
                              f"stores; Used 32 registers"}, "", ops=(),
        min_registers=None)
    assert found == problems


@pytest.mark.parametrize("C, E, node_of, want", [
    (1_000_000, 0, False, 18_000_000 + 4 * (4 + 3 * 64 * 4)),
    (1_000_000, 0, True, 22_000_000 + 4 * (4 + 3 * 64 * 4)),
    (1_000_000, 984_375, False,
     18_000_000 + 9_843_750 + 4 * (4 + 3 * 64 * 4))])
def test_sched_bytes_reads_each_input_and_writes_each_output_once(
        C, E, node_of, want):
    assert chip_smoke.sched_bytes(C, E, 1, 64, 4, node_of) == want
    row = chip_smoke.bound_row(want)
    assert row["bound_by"] == "bytes"
    assert row["bound_ms"] == pytest.approx(want / 3.35e12 * 1e3)


@pytest.mark.parametrize("name", list(chip_smoke.SCHED_TICKS))
def test_sched_ticks_are_the_plain_drives_at_full_size(name):
    """The card's tick counts are the plain drive's on the full graphs
    (which equals jax_drive's: tests/test_torch_benchmarks.py)."""
    from ray_tpu_torch._private import benchmarks as B

    g = B.CONFIGS[name]()
    *_rest, ticks = B.kernels.drive(*B.device_state(g, "cpu"),
                                    threshold=chip_smoke.SCHED_THRESHOLD,
                                    max_ticks=g.max_ticks)
    assert int(ticks) == chip_smoke.SCHED_TICKS[name]


def test_pack_batch_is_seeded_and_every_bundle_demands_a_cpu():
    a, b = chip_smoke.pack_batch(), chip_smoke.pack_batch()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    demands, tiers, cap = a
    assert demands.shape == (chip_smoke.PACK_GANGS, chip_smoke.PACK_BUNDLES,
                             4)
    assert (demands[..., 0] >= 1).all() and set(tiers.tolist()) == {0, 1, 2}
    assert cap.shape == (chip_smoke.PACK_NODES, 4)


@pytest.mark.parametrize("strict", [False, True])
def test_pack_check_holds_the_plain_pack_to_the_oracle(strict):
    from ray_tpu_torch._private.scheduler import kernels as sk

    equal, (node_of, ok, _avail) = chip_smoke.pack_check(
        sk, torch.device("cpu"), strict)
    assert equal and ok.any() and (node_of[ok] >= 0).all()


def test_sched_table_rows_carry_every_key():
    row = {"max_abs_err": 0.0, "plain_ms": 2.0, "bound_ms": 0.005,
           "bound_by": "bytes"}
    table = chip_smoke.sched_table(
        {"scheduler_tick": {**row, "ms": 0.06},
         "pack_many": {**row, "ms": 0.4}},
        {"north_star": {**row, "device_ms": 0.08}},
        {"tick": 464, "drive": 28, "pack_many": 1, "pack_many_tiered": 1})
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert [r["name"] for r in table] == ["scheduler_tick", "scheduler_drive",
                                          "pack_many"]
    assert all(set(r) == keys and r["route"] == "cuda" for r in table)
    assert [r["launches"] for r in table] == [464, 28, 1]
    assert [r["ms"] for r in table] == [0.06, 0.08, 0.4]
    assert table[0]["replaces"] == \
        "ray_tpu/_private/scheduler/kernels.py:707 (XLA)"


def _device_cpu(sk, snap, threshold=0.5):
    """What TensorScheduler._device_assign returns for snap, on the host."""
    ready_cls, demands, avail, cap, mask, spread = (snap[1], snap[2],
                                                    snap[3], snap[4],
                                                    snap[5], snap[6])
    uniq, inv = np.unique(ready_cls, return_inverse=True)
    return sk.assign(inv.astype(np.int32), demands[uniq], avail, cap,
                     threshold, mask[uniq], spread[uniq], device="cpu")


@pytest.mark.parametrize("n_classes", [1, 64])
def test_replay_oracle_accepts_the_device_path_and_rejects_a_swap(n_classes):
    from ray_tpu_torch._private.scheduler import kernels as sk

    snaps = []
    for seed in range(3):
        snap = chip_smoke.crossover_snapshot(512, n_classes, seed)
        node_of, avail = _device_cpu(sk, snap)
        snaps.append((snap, node_of, avail))
    assert chip_smoke.replay_oracle(sk, snaps, 0.5) == 0
    snap, node_of, avail = snaps[0]
    plain = ~snap[6][snap[1]]                 # tasks of non-SPREAD classes
    i, j = np.flatnonzero(plain & (node_of >= 0))[:2]
    bad = node_of.copy()
    bad[i], bad[j] = node_of[j], node_of[i]
    if bad[i] == bad[j]:
        bad[i] = -1
    assert chip_smoke.replay_oracle(sk, [(snap, bad, avail)], 0.5) == 1
    assert chip_smoke.replay_oracle(
        sk, [(snap, node_of, avail + 1)], 0.5) == 1


def test_assign_agrees_holds_spread_classes_to_node_counts():
    cls = np.asarray([0, 0, 1, 1], dtype=np.int32)
    spread = np.asarray([False, True])
    avail = np.zeros((2, 4), np.float32)
    want = (np.asarray([0, 1, 0, 1]), avail)
    swapped = (np.asarray([0, 1, 1, 0]), avail)   # spread tasks swapped
    assert chip_smoke.assign_agrees(swapped, want, cls, spread)
    moved = (np.asarray([0, 1, 1, 1]), avail)     # a spread count changes
    assert not chip_smoke.assign_agrees(moved, want, cls, spread)
    plain = (np.asarray([1, 0, 0, 1]), avail)     # a plain task moved
    assert not chip_smoke.assign_agrees(plain, want, cls, spread)


def test_crossover_snapshots_are_seeded_and_dyadic():
    a = chip_smoke.crossover_snapshot(1024, 64, seed=3)
    b = chip_smoke.crossover_snapshot(1024, 64, seed=3)
    assert all(np.array_equal(x, y) for x, y in zip(a[:7], b[:7]))
    assert a[2].shape == (64, 4) and a[4].shape == (
        chip_smoke.CROSSOVER_NODES, 4)
    assert np.all(a[2] * 4 == np.round(a[2] * 4))   # quarters: exact in f32
    one = chip_smoke.crossover_snapshot(64, 1)
    assert one[5].all() and not one[6].any()


def test_crossover_verdict_is_the_smallest_k_of_a_winning_run():
    """phase_crossover's verdict per class count, with the timings
    replaced by a fake _assign whose cost depends on backend and k."""
    class Config:
        sched_backend = "numpy"

        def set(self, name, value):
            setattr(self, name, value)

    class Sched:
        def __init__(self, config):
            self.config = config

        def _assign(self, snap):
            k, K = len(snap[0]), snap[2].shape[0]
            cuda = self.config.sched_backend == "cuda"
            # cuda wins by 2x at 64 classes from k = 256; never at 1 class
            slow = (K > 1 and k < 256) or K == 1
            time.sleep(0.0 if not cuda else (0.002 if slow else 0.0))
            if not cuda:
                time.sleep(0.001 if K > 1 else 0.0)
            node_of = np.full(k, -1, dtype=np.int32)
            return snap[0], node_of, snap[3]

    import time

    config = Config()
    rows, from_k = chip_smoke.phase_crossover(torch, Sched(config), config)
    assert len(rows) == len(chip_smoke.CROSSOVER_K) * len(
        chip_smoke.CROSSOVER_CLASSES)
    assert all(r["equal"] for r in rows)
    assert from_k == {1: None, 64: 256}


def test_assign_timing_medians_a_window():
    calls = [(0.0, 10, 1e-3, 1.0, 0.1), (1.0, 20, 2e-3, 2.0, 0.2),
             (2.0, 30, 3e-3, 3.0, 0.3), (3.0, 40, 4e-3, None, None)]
    got = chip_smoke.assign_timing(calls, 1.0, 3.5)
    assert got == {"assigns": 3, "median_k": 30, "host_us": 3000.0,
                   "stream_us": 3000.0, "kernel_us": 300.0}
    assert chip_smoke.assign_timing([], 0.0)["host_us"] is None


def test_assign_bytes_read_inputs_and_write_outputs_once():
    k, K, N = 4096, 3, 64
    want = (4 * k                       # the batch's classes, int32
            + 4 * K * 4 + 2 * 4 * N * 4   # demands, avail, cap (f32)
            + K * N + K                 # class mask and spread (bool)
            + 4 * k + 4 * N * 4)        # node_of and the new avail
    assert chip_smoke.assign_bytes(k, K, N) == want


@pytest.mark.parametrize("n", [1, 2, 19, 20, 64, 100])
def test_quantiles_are_servings_nearest_rank(n):
    """Client-side quantiles read a sample list as Serve's TTFT window
    reads its own (sorted[min(n - 1, int(q * n))])."""
    from ray_tpu_torch.serve.core import _ServeMetrics

    xs = [float(x) for x in np.random.default_rng(n).permutation(n)]
    window = _ServeMetrics()
    for x in xs:
        window._window.append(x)
    got = chip_smoke.quantiles(xs)
    assert got == {"p50": window.ttft_quantile(0.5),
                   "p95": window.ttft_quantile(0.95), "max": float(n - 1)}
    with pytest.raises(AssertionError):
        chip_smoke.quantiles([])


def test_stream_record_takes_ttft_at_the_first_token():
    clock = iter([1.0, 3.0, 5.0, 8.0]).__next__
    frames = [{"tokens": [], "done": False}, {"tokens": [7], "done": False},
              {"tokens": [8, 9], "done": False}, {"tokens": [], "done": True}]
    assert chip_smoke.stream_record(iter(frames), 0.5, clock) == (
        [7, 8, 9], 0.5, 2.5)
    with pytest.raises(AssertionError, match="done"):
        chip_smoke.stream_record(iter(frames[:3]), 0.0, iter(
            [1.0, 2.0]).__next__)
    with pytest.raises(AssertionError, match="without a token"):
        chip_smoke.stream_record(iter([{"tokens": [], "done": True}]), 0.0,
                                 iter([1.0]).__next__)


def test_serve_round_runs_every_stream_and_summarises():
    def open_stream(i, prompt):
        return iter([{"tokens": [i, prompt[0]], "done": False},
                     {"tokens": [1], "done": True}])

    results, dt = chip_smoke.serve_round(open_stream, [[5], [6], [7]])
    assert [r[0] for r in results] == [[0, 5, 1], [1, 6, 1], [2, 7, 1]]
    assert all(0 <= r[1] <= r[2] <= dt for r in results)
    row = chip_smoke.round_summary(results, dt, 3, 10)
    assert row["requests"] == 3 and row["tokens"] == 9
    assert row["ttft_s"]["max"] <= row["latency_s"]["max"]
    with pytest.raises(AssertionError, match="malformed"):
        chip_smoke.round_summary(results, dt, 3, 7)   # 7 is out of vocab
    with pytest.raises(AssertionError, match="malformed"):
        chip_smoke.round_summary(results, dt, 4, 10)


def test_serve_round_raises_when_a_stream_fails():
    def open_stream(i, prompt):
        if i == 1:
            raise RuntimeError("replica gone")
        return iter([{"tokens": [1], "done": True}])

    with pytest.raises(AssertionError, match="replica gone"):
        chip_smoke.serve_round(open_stream, [[1], [2], [3]])


@pytest.mark.parametrize("launches, steps, ok", [
    (8 * 256, 256, True), (8 * 256 - 1, 256, False), (0, 0, False),
    (8 * 384, 256 + 128, True), (8 * 256, 257, False)])
def test_serve_launch_rule(launches, steps, ok):
    """8 layers x the decode steps summed over the decode engines, and
    more than none."""
    problem = chip_smoke.launch_rule(launches, 8, steps)
    assert (problem is None) is ok, problem


def _logits_of(table):
    """A model whose next-token logits depend on the last token only."""
    def logits_of(toks):
        return torch.tensor(table[toks[-1]], dtype=torch.float32)
    return logits_of


# vocab 4: after 0 comes 1, after 1 comes 2 (a near-tie with 3: 1e-4
# apart), after 2 comes 3 (clear), after 3 comes 0
_TABLE = [[0.0, 1.0, 0.0, 0.0], [0.0, 0.0, 2.0, 2.0 - 1e-4],
          [0.0, 0.0, 0.0, 5.0], [9.0, 0.0, 0.0, 0.0]]


def test_greedy_parity_exact_stream():
    compared, ties = chip_smoke.greedy_parity(
        torch, _logits_of(_TABLE), [[0]], [[1, 2, 3, 0]], 4)
    assert (compared, ties) == (4, [])


def test_greedy_parity_passes_a_near_tie_and_stops_there():
    """At the tie after token 1 the output took 3 where the model says 2:
    allowed (gap 1e-4 < 1e-3), and the diverged rest is not compared."""
    compared, ties = chip_smoke.greedy_parity(
        torch, _logits_of(_TABLE), [[0]], [[1, 3, 3, 3]], 4)
    assert compared == 2 and len(ties) == 1
    assert ties[0]["step"] == 1 and ties[0]["gap"] == pytest.approx(1e-4,
                                                                    rel=1e-2)


@pytest.mark.parametrize("out", [[1, 2, 0, 0], [2, 2, 3, 0], [1, 2, 3]])
def test_greedy_parity_rejects_a_clear_mismatch_or_a_short_stream(out):
    with pytest.raises(AssertionError):
        chip_smoke.greedy_parity(torch, _logits_of(_TABLE), [[0]], [out], 4)


# -- phase process's checks ----------------------------------------------

def test_compute_apps_parses_nvidia_smi_rows():
    text = "1, 774 MiB\n1, 2316 MiB\n"
    assert chip_smoke.compute_apps(text) == [(1, 774), (1, 2316)]
    assert chip_smoke.compute_apps("") == []


@pytest.mark.parametrize("before, with_actor, pid, want", [
    # nvidia-smi reports the actor's own pid
    ([(10, 700)], [(10, 700), (641, 1700)], 641, (True, "pid")),
    # it reports every process under one pid of another namespace: the
    # actor shows as one row more
    ([(1, 780)], [(1, 2480), (1, 2480)], 641, (True, "row")),
    # no new row, or rows under several foreign pids: not shown
    ([(1, 780)], [(1, 2480)], 641, (False, None)),
    ([(1, 780)], [(1, 2480), (7, 2480)], 641, (False, None)),
])
def test_shows_process(before, with_actor, pid, want):
    assert chip_smoke.shows_process(before, with_actor, pid) == want


@pytest.mark.parametrize("rows_after, used_after, alive, ok", [
    ([(1, 780)], 789, False, True),
    ([(1, 780)], 789 + chip_smoke.PROCESS_MEM_SLACK_MIB, False, True),
    ([(1, 780)], 790 + chip_smoke.PROCESS_MEM_SLACK_MIB, False, False),
    ([(1, 2480), (1, 2480)], 789, False, False),
    ([(1, 780)], 789, True, False),
])
def test_released_rule(rows_after, used_after, alive, ok):
    problem = chip_smoke.released_rule([(1, 780)], 789, rows_after,
                                       used_after, alive)
    assert (problem is None) == ok


def test_arena_holds():
    assert chip_smoke.arena_holds(100, 10, 100, 10)
    assert not chip_smoke.arena_holds(99, 10, 100, 20)
    assert not chip_smoke.arena_holds(105, 10, 100, 10)


def test_pid_alive():
    import os
    import subprocess
    import sys

    assert chip_smoke.pid_alive(os.getpid())
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    assert not chip_smoke.pid_alive(p.pid)


def test_process_phase_sizes():
    """The cuts phase process states: 5k map-reduce tasks, 16 actor
    processes x 100 calls, 3 x 32 MiB through a 64 MiB arena."""
    assert chip_smoke.PROCESS_TASKS == 5_000
    assert (chip_smoke.PROCESS_ACTORS, chip_smoke.PROCESS_CALLS) == (16, 100)
    assert chip_smoke.SPILL_OBJECTS * chip_smoke.SPILL_OBJECT_BYTES \
        > chip_smoke.SPILL_ARENA_BYTES == 64 << 20
    assert chip_smoke.ARENA_TENSOR_BYTES == 64 << 20
    assert chip_smoke.REF_MODULES == ("jax", "flax", "ray_tpu")


def test_process_phase_helpers_run_on_the_host():
    """The fan-out, map-reduce, actor and spill helpers of phase process
    through a 2-worker process-mode runtime at small sizes (the card's
    parts, the CUDA put and the engine actor, run only there)."""
    import ray_tpu_torch as ray

    ray.shutdown()
    ray.init(num_workers=2, scheduler="tensor", _system_config={
        "worker_mode": "process", "sched_device": "cpu",
        "object_store_memory": 4 << 20})
    try:
        w = ray._worker.get_worker()
        assert chip_smoke.wait_workers_ready(w.process_pool) < 120
        mods = chip_smoke.worker_modules(ray, 2)
        assert all(m == [] and c == "" for m, c in mods.values())
        dt, out = chip_smoke.runtime_fanout_batched(ray, 50)
        assert out == [None] * 50 and dt > 0
        _dt, tasks, total, want = chip_smoke.runtime_map_reduce(ray, 505)
        assert tasks == 505 and total == want
        assert chip_smoke.runtime_actors(ray, 2, 5)[1] == 0
    finally:
        ray.shutdown()


# -- the data and cluster phases' helpers ---------------------------------------

def _removed(snap, rows):
    """snap with the scheduler rows in ``rows`` zeroed, as remove_node
    leaves them."""
    ready_idx, ready_cls, demands, avail, cap, mask, spread = snap[:7]
    avail, cap = avail.copy(), cap.copy()
    avail[rows], cap[rows] = 0.0, 0.0
    return (ready_idx, ready_cls, demands, avail, cap, mask, spread) \
        + snap[7:]


def test_dead_row_check_counts_only_snapshots_after_the_removal():
    """Snapshots whose dead rows still have capacity were taken before the
    removal and are not counted; after it, the device path's choices
    pass, and a task placed on the dead row is caught (and differs from
    assign_np, which never uses an all-zero row)."""
    from ray_tpu_torch._private.scheduler import kernels as sk

    before = chip_smoke.crossover_snapshot(256, 4, seed=1)
    after = _removed(chip_smoke.crossover_snapshot(256, 4, seed=2), [3])
    snaps = [(s, *_device_cpu(sk, s)) for s in (before, after)]
    assert chip_smoke.dead_row_check(sk, snaps, {3}, 0.5) == (1, 0, 0)
    _snap, node_of, avail = snaps[1]
    bad = node_of.copy()
    bad[np.flatnonzero(bad >= 0)[0]] = 3
    assert chip_smoke.dead_row_check(
        sk, [(after, bad, avail)], {3}, 0.5) == (1, 1, 1)
    # a snapshot from before the node existed has no such row
    assert chip_smoke.dead_row_check(sk, snaps, {64}, 0.5)[0] == 0


def test_detection_deadline_is_the_budget_plus_five_periods():
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    assert chip_smoke.detection_deadline(GLOBAL_CONFIG) == pytest.approx(
        GLOBAL_CONFIG.health_check_timeout_s
        + 5 * GLOBAL_CONFIG.health_check_period_s)


def test_native_exchange_names_the_ports_own_build(tmp_path):
    class Lib:
        _name = str(tmp_path / "_build" / "native_exchange-0123.so")

    class Shuffle:
        def __init__(self, lib):
            self._lib = lambda: lib

    assert chip_smoke.native_exchange(Shuffle(Lib()), tmp_path) == (
        Lib._name, True)
    assert not chip_smoke.native_exchange(Shuffle(None), tmp_path)[1]
    other = Lib()
    other._name = str(tmp_path / "ray_tpu" / "_native" / "_exchange.so")
    assert not chip_smoke.native_exchange(Shuffle(other), tmp_path)[1]
    from ray_tpu_torch.data import _shuffle

    repo = Path(chip_smoke.__file__).resolve().parent
    assert chip_smoke.native_exchange(_shuffle, repo / "ray_tpu_torch")[1]


def test_wait_running_on_polls_the_task_table():
    class Sched:
        def __init__(self):
            self.calls = 0

        def task_table(self):
            self.calls += 1
            state = "RUNNING" if self.calls > 3 else "WAITING"
            return [{"node_index": 0, "state": "RUNNING"},
                    {"node_index": 2, "state": state}]

        def stats(self):
            return {"device_assigns": 7, "device_assign_errors": 0}

    class Entry:
        def __init__(self, index, state, reason):
            self.index, self.state, self.death_reason = index, state, reason

    class Gcs:
        def node_table(self):
            return [Entry(0, "ALIVE", None), Entry(5, "DEAD", "stale")]

    class W:
        scheduler = Sched()
        gcs = Gcs()

    assert chip_smoke.wait_running_on(W(), 2) >= 0
    # the timeout names the rows that ran, the nodes' states and reasons
    # and the device assigns
    with pytest.raises(AssertionError, match=r"row 5 .*by row \{0: \d+, "
                       r"2: \d+\}.*5: \('DEAD', 'stale'\).*device "
                       r"assigns 7, errors 0"):
        chip_smoke.wait_running_on(W(), 5, timeout=0.05)


def test_data_helpers_on_the_port_runtime():
    """data_pipeline is BASELINE config 3's pipeline; data_shuffle and
    data_batches pass on the host at the phase's own sizes."""
    import ray_tpu_torch as ray
    from ray_tpu_torch import data
    from ray_tpu_torch.data import _shuffle

    ray.shutdown()
    ray.init(num_workers=4, scheduler="tensor",
             _system_config={"sched_device": "cpu"})
    try:
        rows = chip_smoke.data_pipeline(data, 20).take_all()
        assert rows == [2 * i for i in range(20 * chip_smoke.
                                             DATA_ROWS_PER_BLOCK)]
        row, problems = chip_smoke.data_batches(data, torch.device("cpu"))
        assert not problems and row["sum"] == row["want"]
        assert row["batches"] == 248    # 8 blocks of 125k rows
        saved = chip_smoke.SHUFFLE_ROWS, chip_smoke.SHUFFLE_BLOCKS
        chip_smoke.SHUFFLE_ROWS, chip_smoke.SHUFFLE_BLOCKS = 5000, 50
        try:
            row, problems = chip_smoke.data_shuffle(
                data, _shuffle, Path(ray.__file__).resolve().parent)
        finally:
            chip_smoke.SHUFFLE_ROWS, chip_smoke.SHUFFLE_BLOCKS = saved
        assert not problems and row["native"] and row["same_order"]
    finally:
        ray.shutdown()


@pytest.mark.parametrize("cf", [0.5, 4.0])
def test_moe_dropped_shares_respect_capacity(cf):
    """Phase moe's dropped share a layer: one share per MoE layer, and
    bounded by the capacity alone. At cf = 0.5 the experts hold half the
    tokens at most, so each layer drops at least half; at cf = E (4) each
    expert has a slot for every token, so none is dropped."""
    from ray_tpu_torch.models import transformer as tt

    cfg = tt.TransformerConfig(
        vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=64, max_seq_len=64, dtype=torch.float32, moe=True,
        moe_num_experts=4, moe_capacity_factor=cf)
    model = tt.Transformer(cfg, device="cpu").load_params(tt.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    tokens = torch.randint(0, 64, (3, 40),
                           generator=torch.Generator().manual_seed(1))
    got = chip_smoke.moe_dropped_shares(torch, model, tokens)
    assert len(got) == cfg.n_layers
    if cf < 1.0:
        assert all(0.5 <= share < 1.0 for share in got)
    else:
        assert got == [0.0] * cfg.n_layers


# -- phase ops's helpers ------------------------------------------------------

def test_ops_fair_keys_are_seeded_and_split_by_tier():
    keys = chip_smoke.ops_fair_keys()
    assert keys == chip_smoke.ops_fair_keys()
    assert len(keys) == 2 * chip_smoke.OPS_FAIR_TASKS
    for tenant in ("prod", "batch"):
        tiers = [t for _, t, n in keys if n == tenant]
        assert tiers.count(1) == tiers.count(0) == \
            chip_smoke.OPS_FAIR_TASKS // 2


def test_ops_fair_order_is_the_references_plane_order():
    """The simulated order under the port's plane equals the one under
    the reference's, and it passes the part's own rules."""
    from ray_tpu._private.qos import QosPlane as RefPlane
    from ray_tpu_torch._private.qos import QosPlane

    keys = chip_smoke.ops_fair_keys()
    want = chip_smoke.ops_fair_order(QosPlane, keys)
    assert want == chip_smoke.ops_fair_order(RefPlane, keys)
    assert chip_smoke.ops_fair_check(want, want, keys) == []
    # a FIFO completion order breaks every rule
    fifo = [k for k, _, _ in keys]
    problems = chip_smoke.ops_fair_check(fifo, want, keys)
    assert any("differs" in p for p in problems)
    assert any("after a tier-0 key" in p for p in problems)


def test_ops_window_top_reads_the_whole_window():
    from ray_tpu_torch._private import profile_plane

    rows = [{"node": n % 3, "task": f"t{n}", "stack": f"a;b{n}",
             "count": n + 1} for n in range(30)]
    report = profile_plane.flamegraph_report(rows)
    top = chip_smoke.ops_window_top(report)
    assert len(top) == 30 > len(report["top_tasks"])
    assert top[:15] == report["top_tasks"]


def test_ops_memory_rule():
    assert chip_smoke.ops_memory_rule(1000, 1064) is None
    assert chip_smoke.ops_memory_rule(1000, 1065) is not None


def test_ops_state_check_names_what_disagrees():
    ran = {"task_names": ["f"], "actor": "a", "object": "00ff", "nodes": 1,
           "tenants": ["p"]}
    good = {"list_tasks": ([], []),
            "list_tasks_detail": ([{"task_id": "1", "name": "f",
                                    "state": "FINISHED"}],) * 2,
            "list_actors": ([{"actor_id": "x", "name": "a",
                              "state": "ALIVE"}],) * 2,
            "list_objects": ([{"object_id": "00ff"}],) * 2,
            "list_nodes": ([{"node_id": "n", "index": 0,
                             "state": "ALIVE"}],) * 2,
            "list_tenants": ([{"tenant": "p"}],) * 2,
            "task_timeline": ([{"name": "f"}],) * 2,
            "list_traces": ([{"trace_id": "t", "root": "f"}],) * 2}
    assert chip_smoke.ops_state_check(good, ran) == []
    bad = dict(good, list_actors=([{"actor_id": "x", "name": "a",
                                    "state": "DEAD"}], []))
    problems = chip_smoke.ops_state_check(bad, ran)
    assert any("dashboard rows" in p for p in problems)
    assert any("not ALIVE" in p for p in problems)


def test_ops_group_alive_finds_a_live_group():
    import os
    import subprocess
    import sys

    p = subprocess.Popen([sys.executable, "-c", "import time; "
                          "time.sleep(30)"], start_new_session=True)
    try:
        assert p.pid in chip_smoke.ops_group_alive(p.pid)
    finally:
        p.kill()
        p.wait()
    assert chip_smoke.ops_group_alive(p.pid) == []
    assert os.getpid() not in chip_smoke.ops_group_alive(p.pid)


def test_ops_parts_run_their_tasks_on_the_host(tmp_path):
    """The batch, prod and snapshot tasks of phase ops, called directly
    on the CPU at small sizes: the batch trains until its gate and marks,
    a second attempt waits for the gate; the prod task waits for its go
    file, decodes and marks; the snapshot computation is seeded."""
    import threading

    files = {n: str(tmp_path / n) for n in ("gate", "attempts", "progress",
                                            "marks", "leased", "go",
                                            "started", "hold")}
    model = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2,
                 n_kv_heads=1, d_ff=64, max_seq_len=32)
    threading.Timer(0.5, lambda: open(files["gate"], "w").close()).start()
    out = chip_smoke.ops_batch_train(model, 2, 8, files["gate"],
                                     files["attempts"], files["progress"],
                                     files["marks"], 2, "cpu")
    assert out["attempt"] == 1 and out["steps"] >= 2
    assert out["launches"] == {n: 0 for n in out["launches"]}  # plain path
    again = chip_smoke.ops_batch_train(model, 2, 8, files["gate"],
                                       files["attempts"], files["progress"],
                                       files["marks"], 2, "cpu")
    assert again["attempt"] == 2 and again["steps"] == 2
    assert chip_smoke.read_marks(files["marks"]) == ["batch", "batch"]

    from ray_tpu_torch.models.inference import InferenceConfig

    serve = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2,
                 n_kv_heads=1, d_ff=64, max_seq_len=64)
    icfg = InferenceConfig(batch_size=2, page_size=8, max_pages_per_seq=4,
                           num_pages=16, prefill_buckets=(8,),
                           max_new_tokens=4)
    for n in ("go", "hold"):
        open(files[n], "w").close()
    got = chip_smoke.ops_prod_decode(serve, icfg, [[1, 2], [3]], 4, files,
                                     "cpu")
    assert [len(t) for t in got["tokens"]] == [4, 4]
    assert got["decode_steps"] > 0
    assert chip_smoke.read_marks(files["marks"])[-1] == "prod"
    a = chip_smoke.ops_card_compute(3, 16, "cpu")
    assert a.shape == (16,) and bool((a == chip_smoke.ops_card_compute(
        3, 16, "cpu")).all())


def test_mark_leaf_holds_a_held_worker_before_its_mark(tmp_path):
    """A process outside hold_pids marks at once; one inside waits hold_s
    before its mark, so a kill during the hold leaves none."""
    import hashlib
    import os
    import threading
    import time

    path = str(tmp_path / "marks")
    want = hashlib.sha256(b"free").hexdigest()
    assert chip_smoke.mark_leaf("free", path, 0.0, frozenset({-1})) == want
    assert chip_smoke.read_marks(path) == ["free"]

    t = threading.Thread(target=chip_smoke.mark_leaf, args=(
        "held", path, 0.0, frozenset({os.getpid()}), 1.0))
    t0 = time.perf_counter()
    t.start()
    time.sleep(0.3)
    assert chip_smoke.read_marks(path) == ["free"]
    t.join(10)
    assert time.perf_counter() - t0 >= 1.0
    assert chip_smoke.read_marks(path) == ["free", "held"]
