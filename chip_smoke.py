"""Drive the PyTorch port on one NVIDIA card (H100, sm_90a) and check it.

    python3 chip_smoke.py

from the repository root.  It needs a CUDA card, ``nvcc`` and the sources
under ``src/``; without a card it exits non-zero before printing anything
else.  Phases (every mismatch raises, so any failure exits non-zero):

  1. the card's name and power limit; build the CUDA kernels.
  2. each kernel against its plain PyTorch version on the card: both
     variants x 8 policies x deadline off/on, at K=100 (S=5) and K=10^4
     (S=5, S=50) with G=4 grid points, and at the shapes of the sweeps
     below: the legacy kernel at G=24, K=100; the sampled kernel at G=8,
     K=10^4 and at ``metro-congestion``'s G=1, K=10^5, C=10^4 with the
     per-cell congestion multiplier on the mean throughput.  States are
     warmed by 20 plain rounds.  Selections and flags exact; state and
     round times within rtol 1e-6.
  3. ``sweep("paper-baseline")`` at K=100: 8 policies x eta (1.0, 1.5, 1.9)
     x 8 seeds x 500 rounds through the legacy kernel, plus a small run
     fed the same draws on the card and on the CPU (plain path), which must
     agree.
  4. the streamed-sampling path at K=10^4 (8 policies x 8 seeds x 500
     rounds) and ``flaky-clients`` with a round deadline.
  5. ``metro-congestion`` at K=10^5 (C=10^4 candidates): 8 policies x 1
     seed x 100 rounds.

Launch counts are zeroed before each sweep and read after it; each sweep
must launch its kernel once per (policy, round).  The second-to-last line
is a JSON object with each kernel's launches, error against the plain
version and times; the last line is the device summary.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device-memory rate
FP32_OPS_PER_S = 67e12         # H100 SXM float32 rate outside tensor cores
DEADLINE = 2500.0              # round deadline (s) of the fault runs
RTOL = 1e-6

KERNELS = {
    "bandit_round": dict(
        replaces="src/repro/kernels/bandit_round.py:289"),
    "bandit_round_sampled": dict(
        replaces="src/repro/kernels/bandit_round.py:373"),
}

# phase 2's cases, (scenario, G, K, S) by kernel; the last ones are the
# shapes at which phases 3-5 drive each kernel
PHASE2_CASES = {
    "bandit_round": [
        ("paper-baseline", 4, 100, 5), ("paper-baseline", 4, 10_000, 5),
        ("paper-baseline", 4, 10_000, 50), ("paper-baseline", 24, 100, 5)],
    "bandit_round_sampled": [
        ("paper-baseline", 4, 100, 5), ("paper-baseline", 4, 10_000, 5),
        ("paper-baseline", 4, 10_000, 50), ("paper-baseline", 8, 10_000, 5),
        ("metro-congestion", 1, 100_000, 5)],
}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def round_inputs(env, scen, g, k, c, s, policy, sampled, failure, gen):
    """One round's inputs on the card for a [g] grid (random draws from
    ``gen``); the mean throughput carries ``scen``'s per-cell congestion
    multiplier, as the sweep's rounds do.  With ``failure`` the fault
    probabilities are flaky-clients'."""
    from repro_torch.sim.engine import scenario_thr_mult
    from repro_torch.sim.scenarios import get_scenario
    dev = env.mean_theta.device
    cand = torch.rand((g, k), generator=gen, device=dev).topk(c).indices
    kw = dict(cand_idx=cand.sort(1).values.to(torch.int32).contiguous(),
              rand=(torch.rand((g, k), generator=gen, device=dev)
                    if policy == "random" else None),
              fault_u=(torch.rand((g, 3, s), generator=gen, device=dev)
                       if failure else None))
    normals = (torch.randn((g, scen.congestion_cells), generator=gen,
                           device=dev)
               if scen.congestion_cells > 0 and scen.congestion_sigma > 0.0
               else None)
    mult = scenario_thr_mult(scen, env.cell_id, normals, 1)
    theta = env.mean_theta.expand(g, k) if mult is None else (
        env.mean_theta * mult).expand(g, k)
    theta = theta.contiguous()
    gamma = env.mean_gamma.expand(g, k).contiguous()
    eta = torch.full((g,), 1.5, device=dev)
    if sampled:
        kw.update(u2=torch.rand((g, 2, c), generator=gen, device=dev),
                  theta_mu=theta, gamma_mu=gamma, n_samples=env.n_samples,
                  eta=eta, model_bits=146.4e6)
    else:
        from repro_torch.sim.engine import sample_times
        t_ud, t_ul = sample_times(
            env.n_samples, theta, gamma, eta, 146.4e6,
            torch.rand((g, k), generator=gen, device=dev),
            torch.rand((g, k), generator=gen, device=dev))
        kw.update(t_ud=t_ud.contiguous(), t_ul=t_ul.contiguous())
    fault = get_scenario("flaky-clients").fault.probs if failure else None
    return kw, fault


def call_round(fn, state, kw, policy, s, fault, sampled):
    from repro_torch.core import bandit
    common = dict(policy=policy, s_round=s, decay=bandit.policy_decay(policy),
                  fault=fault, deadline=DEADLINE if fault else None,
                  fault_u=kw["fault_u"])
    hyper = bandit.DEFAULT_HYPERS[policy]
    if sampled:
        return fn(state, kw["cand_idx"], kw["u2"], kw["rand"], kw["theta_mu"],
                  kw["gamma_mu"], kw["n_samples"], kw["eta"],
                  kw["model_bits"], hyper, **common)
    return fn(state, kw["cand_idx"], kw["t_ud"], kw["t_ul"], kw["rand"],
              hyper, **common)


def compare(out_k, out_p, where: str) -> float:
    """Selections and flags exact, state and round times within RTOL;
    returns the largest absolute float difference."""
    from repro_torch.core.bandit import STATE_FIELDS
    if not torch.equal(out_k[1], out_p[1]):
        raise AssertionError(f"{where}: selections differ\n{out_k[1]}\n"
                             f"{out_p[1]}")
    if len(out_p) == 4 and not torch.equal(out_k[3], out_p[3]):
        raise AssertionError(f"{where}: flags differ")
    pairs = [(out_k[2], out_p[2], "round_time")] + [
        (getattr(out_k[0], f), getattr(out_p[0], f), f)
        for f in STATE_FIELDS]
    worst = 0.0
    for a, b, name in pairs:
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, rtol=RTOL, atol=0,
                                       msg=f"{where}: {name}")
            worst = max(worst, (a - b).abs().max().item())
        elif not torch.equal(a, b):
            raise AssertionError(f"{where}: {name} differs")
    return worst


def time_ms(fn, n: int, reps: int = 3) -> float:
    """ms per call: CUDA events around a run of ``n`` calls, the median of
    ``reps`` runs, after one warm-up call."""
    fn()
    runs = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        torch.cuda.synchronize()
        runs.append(e0.elapsed_time(e1) / n)
    return statistics.median(runs)


def launcher(sampled):
    from repro_torch.kernels import bandit_round as cuda_round
    return (cuda_round.bandit_round_sampled_launcher if sampled
            else cuda_round.bandit_round_launcher)


def profiled_kernel_ms(launch, n: int) -> float | None:
    """Device time per launch of the round kernel by torch.profiler, or
    None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            launch()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0)
                for e in prof.key_averages() if "bandit_round_kernel" in e.key)
    return total / n / 1e3 if total else None


def bound(policy, g, k, c, s, sampled, failure):
    """Least time (ms) the card needs for one round: the bytes the round
    must move (each input read once, each output written once) over the
    memory rate, against its float operations over the float32 rate."""
    from repro_torch.core.bandit import HIST_WINDOW as W
    from repro_torch.core.bandit import POLICY_STATS, policy_decay, policy_kind
    decays = policy_decay(policy) != 1.0
    gathered = set(POLICY_STATS[policy])
    # per candidate: its index; its times (legacy) or its two uniforms and
    # three means (sampled); the random policy's uniform; the statistics the
    # policy scores (a ring-buffer sum reads W entries; discounted UCB's
    # disc_* are read by the decay pass below)
    per_cand = 4 + (20 if sampled else 8) + (4 if policy == "random" else 0)
    per_cand += sum(4 * W if col.startswith("hist_sum_") else 4
                    for col in gathered if not col.startswith("disc_"))
    # per selected row: read the counters and sums the gather did not; write
    # them, last_ud/ul and one ring slot of hist_ud/ul (disc_* rows are
    # written by the decay pass); n_fail read and written with failures on
    row = 4 * len({"n_sel", "sum_ud", "sum_ul", "sum_tinc", "hist_n"}
                  - gathered) + 4 * 9 + (8 if failure else 0)
    per_g = (c * per_cand + s * row
             + 8                                  # total, read and written
             + (8 + 2 * 4 * 3 * k if decays else 0)  # disc_total, decay pass
             + (4 if sampled else 0)              # eta
             + 4 * s + 4                          # sel, round_time
             + (4 * s + 12 * s if failure else 0))   # flags, fault_u
    nbytes = g * per_g
    # float ops: per candidate ~40 for the Eq. (8) draw (sampled), ~10 for
    # the score, and per selection step ~6 per candidate (greedy) or 1
    steps = 6 if policy_kind(policy) == "greedy" else 1
    ops = g * (c * ((40 if sampled else 0) + 10 + steps * s)
               + (3 * k if decays else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device_and_build() -> None:
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    cached = _build.library_path("bandit_round").exists()
    t0 = time.perf_counter()
    _build.load("bandit_round")
    log(f"[1] bandit_round.cu {'loaded (cached)' if cached else 'built'} "
        f"in {time.perf_counter() - t0:.1f} s")


def phase_kernels(results: dict) -> None:
    from repro_torch.core import bandit
    from repro_torch.kernels import bandit_round as cuda_round
    from repro_torch.kernels import ref
    from repro_torch.sim.engine import EnvArrays
    from repro_torch.sim.scenarios import get_scenario

    dev = torch.device("cuda")
    for sampled in (False, True):
        name = "bandit_round_sampled" if sampled else "bandit_round"
        kern = (cuda_round.bandit_round_sampled_cuda if sampled
                else cuda_round.bandit_round_cuda)
        plain = (ref.bandit_round_sampled_ref if sampled
                 else ref.bandit_round_ref)
        worst = 0.0
        for scen_name, g, k, s in PHASE2_CASES[name]:
            c = math.ceil(0.1 * k)
            scen = get_scenario(scen_name)
            env = EnvArrays.from_scenario(
                scen, scen.build_env(k, np.random.default_rng(0)), dev)
            for policy in bandit.POLICY_NAMES:
                for failure in (False, True):
                    gen = torch.Generator(device=dev)
                    gen.manual_seed(k + s + g + 17 * failure)
                    state = bandit.BanditState.create(g, k, device=dev)
                    for _ in range(20):           # warm with plain rounds
                        kw, fault = round_inputs(env, scen, g, k, c, s,
                                                 policy, sampled, failure,
                                                 gen)
                        state = call_round(plain, state, kw, policy, s,
                                           fault, sampled)[0]
                    kw, fault = round_inputs(env, scen, g, k, c, s, policy,
                                             sampled, failure, gen)
                    out_p = call_round(plain, state.clone(), kw, policy, s,
                                       fault, sampled)
                    out_k = call_round(kern, state.clone(), kw, policy, s,
                                       fault, sampled)
                    torch.cuda.synchronize()
                    where = (f"{name} {scen_name} G={g} K={k} C={c} S={s} "
                             f"{policy} deadline={'on' if failure else 'off'}")
                    worst = max(worst, compare(out_k, out_p, where))
                    ms = time_ms(call_round(
                        launcher(sampled), state.clone(), kw, policy, s,
                        fault, sampled), 100)
                    pms = time_ms(lambda: call_round(
                        plain, state, kw, policy, s, fault, sampled), 3)
                    log(f"[2] {where}: match; kernel {ms:.4f} ms, "
                        f"plain {pms:.3f} ms")
        results[name]["max_abs_err"] = worst
        log(f"[2] {name}: all cases match (max abs err {worst:g})")


def kernel_times(results: dict, name: str, g: int, k: int, s: int) -> None:
    """Kernel, plain and bound times at a sweep's shape (mean over the 8
    policies, which the sweep launches equally often)."""
    from repro_torch.core import bandit
    from repro_torch.kernels import bandit_round as cuda_round
    from repro_torch.kernels import ref
    from repro_torch.sim.engine import EnvArrays
    from repro_torch.sim.scenarios import get_scenario

    sampled = name == "bandit_round_sampled"
    plain = ref.bandit_round_sampled_ref if sampled else ref.bandit_round_ref
    dev = torch.device("cuda")
    c = math.ceil(0.1 * k)
    scen = get_scenario("paper-baseline")
    env = EnvArrays.from_scenario(
        scen, scen.build_env(k, np.random.default_rng(0)), dev)
    ms, pms, prof, bms, by = [], [], [], [], set()
    for policy in bandit.POLICY_NAMES:
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        kw, fault = round_inputs(env, scen, g, k, c, s, policy, sampled,
                                 False, gen)
        state = bandit.BanditState.create(g, k, device=dev)
        launch = call_round(launcher(sampled), state, kw, policy, s, fault,
                            sampled)
        for _ in range(20):                    # leave the cold start
            launch()
        ms.append(time_ms(launch, 200))
        prof.append(profiled_kernel_ms(launch, 50))
        pms.append(time_ms(lambda: call_round(plain, state, kw, policy, s,
                                              fault, sampled), 5))
        b, why = bound(policy, g, k, c, s, sampled, False)
        bms.append(b)
        by.add(why)
    r = results[name]
    r.update(ms=statistics.fmean(ms), plain_ms=statistics.fmean(pms),
             bound_ms=statistics.fmean(bms), bound_by="/".join(sorted(by)),
             shape=dict(g=g, k=k, c=c, s=s))
    log(f"[t] {name} at G={g} K={k} C={c} S={s}: kernel "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
        f"{r['bound_ms']:.6f} ms ({r['bound_by']}); per policy "
        + ", ".join(f"{p}={m:.4f}" for p, m in zip(bandit.POLICY_NAMES, ms)))
    log(f"[t] {name} device time per launch by torch.profiler: "
        + ", ".join(f"{p}={'none' if m is None else f'{m:.4f}'}"
                    for p, m in zip(bandit.POLICY_NAMES, prof)))


def profile_sweep(label: str, **kw) -> None:
    """Where one policy's sweep spends its time: torch.profiler over the
    whole sweep, device time of the round kernel and of all other device
    work against the wall time (the rest is the device idle, waiting on
    the host).  The profiler's own cost inflates the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.sim import engine
    engine.sweep(**kw)                                   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.sweep(**kw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.key, e.self_device_time_total)
              for e in prof.key_averages() if e.device_type == cuda]
    device_us = sum(t for _, t in events)
    kernel_us = sum(t for k, t in events if "bandit_round_kernel" in k)
    top = sorted(events, key=lambda e: -e[1])[:4]
    log(f"[{label}p] profiled sweep {kw.get('policies')} x "
        f"{kw.get('n_rounds')} rounds: wall {wall_us / 1e3:.1f} ms, device "
        f"busy {100 * device_us / wall_us:.1f}% (round kernel "
        f"{100 * kernel_us / wall_us:.2f}%), idle "
        f"{100 * (1 - device_us / wall_us):.1f}%; top device ops "
        + ", ".join(f"{k[:40]}={t / 1e3:.2f} ms" for k, t in top))


def run_sweep(label: str, expect: dict, **kw):
    """One sweep on the card with the launch counts zeroed before and read
    after; each kernel must have launched exactly ``expect`` times."""
    from repro_torch.kernels import bandit_round as cuda_round
    from repro_torch.sim import engine
    cuda_round.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.sweep(**kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(cuda_round.launch_counts)
    if counts != expect:
        raise AssertionError(f"{label}: launches {counts} != {expect}")
    p, e, s, r = res.round_times.shape
    if not (np.isfinite(res.round_times).all()
            and (res.round_times > 0).all()):
        raise AssertionError(f"{label}: non-finite or non-positive times")
    log(f"[{label}] {p} policies x {e} eta x {s} seeds x {r} rounds in "
        f"{wall:.2f} s: {p * r / wall:.1f} rounds/s "
        f"({p * e * s * r / wall:.0f} grid-point rounds/s); launches "
        f"{counts}")
    return res, counts


def phase_paper_sweep(results: dict) -> None:
    from repro_torch.core import bandit
    res, counts = run_sweep(
        "3", {"bandit_round": 8 * 500, "bandit_round_sampled": 0},
        scenario="paper-baseline", etas=(1.0, 1.5, 1.9), seeds=8,
        n_rounds=500, n_clients=100)
    results["bandit_round"]["launches"] = counts["bandit_round"]
    table = res.mean_elapsed()
    log("[3] mean elapsed (s) by policy, eta = " + ", ".join(
        f"{e}" for e in res.etas))
    for name, row in zip(res.policies, table):
        log(f"[3]   {name:16s} " + " ".join(f"{v:12.1f}" for v in row))
    if table.shape != (len(bandit.POLICY_NAMES), 3):
        raise AssertionError("[3] mean_elapsed shape")
    check_against_cpu()
    profile_sweep("3", scenario="paper-baseline", policies=("elementwise_ucb",),
                  etas=(1.0, 1.5, 1.9), seeds=8, n_rounds=100, n_clients=100)


def check_against_cpu() -> None:
    """The same draws through the card (kernels) and the CPU (plain path):
    the round times must agree.  Both paths are run from one set of
    CPU-made draws, so the comparison needs no shared generator."""
    from repro_torch.core import bandit
    from repro_torch.sim import engine
    from repro_torch.sim.scenarios import get_scenario

    scen = get_scenario("flaky-clients")
    for fast, k in ((False, 100), (True, 2000)):
        n_req = math.ceil(0.1 * k)
        env_np = scen.build_env(k, np.random.default_rng(0))
        worst = 0.0
        for policy in bandit.POLICY_NAMES:
            gens = engine.make_generators((0, 1), "cpu")
            draws = [engine.draw_round_inputs(
                gens, n_seeds=2, n_etas=2, k=k, n_req=n_req, s_round=5,
                fast=fast, fluctuate=True, policy=policy, scen=scen,
                fault=scen.fault.probs) for _ in range(50)]
            out = {}
            for dev in ("cpu", "cuda"):
                env = engine.EnvArrays.from_scenario(scen, env_np, dev)
                moved = [engine.RoundDraws(**{
                    f: None if getattr(d, f) is None
                    else getattr(d, f).to(dev)
                    for f in d.__dataclass_fields__}) for d in draws]
                rts, flags, _ = engine.run_rounds(
                    env, torch.tensor([1.0, 1.0, 1.9, 1.9], device=dev),
                    moved, policy=policy, scen=scen, s_round=5,
                    hyper=bandit.DEFAULT_HYPERS[policy], model_bits=146.4e6,
                    fast=fast, deadline=DEADLINE)
                out[dev] = (rts.cpu(), flags.cpu())
            torch.testing.assert_close(out["cuda"][0], out["cpu"][0],
                                       rtol=1e-5, atol=0)
            if not torch.equal(out["cuda"][1], out["cpu"][1]):
                raise AssertionError(f"card vs CPU flags differ ({policy})")
            worst = max(worst, (out["cuda"][0] - out["cpu"][0]).abs().max()
                        .item())
        log(f"[3] card (kernel) vs CPU (plain) on the same draws, "
            f"flaky-clients K={k} {'streamed' if fast else 'legacy'}, "
            f"8 policies x 4 grid points x 50 rounds: round times agree "
            f"(max abs diff {worst:g} s), flags equal")


def phase_fast_path(results: dict) -> None:
    _, counts = run_sweep(
        "4", {"bandit_round": 0, "bandit_round_sampled": 8 * 500},
        scenario="paper-baseline", etas=(1.5,), seeds=8, n_rounds=500,
        n_clients=10_000)
    results["bandit_round_sampled"]["launches"] = counts[
        "bandit_round_sampled"]
    res, _ = run_sweep(
        "4", {"bandit_round": 0, "bandit_round_sampled": 8 * 100},
        scenario="flaky-clients", etas=(1.5,), seeds=8, n_rounds=100,
        n_clients=10_000, deadline=DEADLINE)
    fc = res.fault_counts()
    total = {k: int(v.sum()) for k, v in fc.items()}
    parts = sum(total[k] for k in ("ok", "crashed", "churned",
                                   "deadline_missed", "corrupt"))
    if parts != total["dispatched"]:
        raise AssertionError(f"[4] fault counts do not partition: {total}")
    log(f"[4] flaky-clients deadline={DEADLINE} s fault counts: {total}")
    profile_sweep("4", scenario="paper-baseline", policies=("elementwise_ucb",),
                  etas=(1.5,), seeds=8, n_rounds=100, n_clients=10_000)


def phase_real_size() -> None:
    torch.cuda.reset_peak_memory_stats()
    run_sweep("5", {"bandit_round": 0, "bandit_round_sampled": 8 * 100},
              scenario="metro-congestion", etas=(1.5,), seeds=1,
              n_rounds=100, n_clients=100_000)
    log(f"[5] metro-congestion K=100000 C=10000: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    profile_sweep("5", scenario="metro-congestion",
                  policies=("elementwise_ucb",), etas=(1.5,), seeds=1,
                  n_rounds=100, n_clients=100_000)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script runs on "
                 "the card only")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    results = {name: dict(name=name, route="cuda",
                          source="src/repro_torch/kernels/csrc/"
                                 "bandit_round.cu",
                          library_ms=None, **meta)
               for name, meta in KERNELS.items()}
    t0 = time.perf_counter()
    phase_device_and_build()
    phase_kernels(results)
    phase_paper_sweep(results)
    kernel_times(results, "bandit_round", g=24, k=100, s=5)
    phase_fast_path(results)
    kernel_times(results, "bandit_round_sampled", g=8, k=10_000, s=5)
    phase_real_size()
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in results.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
