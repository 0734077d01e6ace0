"""chip_smoke.py's check of a flash kernel output against its plain version,
and flash_mutants.py's mutations, on the CPU: the check passes rounding at
its dtype's level and rejects a small bias and a wrong row, and every
mutation still finds the one place it breaks in the current source. Also
the ring block check (kernel 2's o, m, l, with exact rows where no key is
visible), the work counted for a block's bound, and the logit comparison
of the ring phase."""

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


def test_every_flash_kernel_is_checked_as_sm90():
    assert chip_smoke.SM90_KERNELS["flash_attention"] == (
        "attention_fwd_kernel", "attention_bwd_dq_kernel",
        "attention_bwd_dkv_kernel")
    assert chip_smoke.SM90_MIN_REGISTERS == 168


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
    ("nvjet_hsh_256x128_64x4_1x2_h_bz_coopA_NTT", "matrix products"),
    ("void at::native::elementwise_kernel<128, 2>", "other")])
def test_kernel_group(name, group):
    assert chip_smoke.kernel_group(name) == group
