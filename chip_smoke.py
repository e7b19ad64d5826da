"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, as the gate runs it
    python3 chip_smoke.py riccati rmpc     # only the named phases

Phases, each of which raises on failure (so the script exits non-zero):
1. device: require CUDA, print versions, the card and its power limit;
2. build: compile `dart_tpu_torch/csrc/*.cu` with nvcc (one process per
   source, all at once), print the seconds, registers and stack frames;
3. pmpc: the PMPC whole-solve kernel against its plain PyTorch version at
   B=4096, N=15, 2 iterations x 3 alphas, in float64 and float32; twice
   the same call and a ragged batch (B=37, the first lanes of the same
   problem) must give the full batch's lanes bit for bit; one lane with
   broken Ad structure must come back +inf (the kernel's own guard);
4. riccati: the Riccati backward kernel against its plain version at
   B=4096, nz=6 (N=15, 20) and nz=10 (N=20), float64 and float32; at N=20
   twice the same call and ragged batches (B=4000 and B=37) must give the
   full batch's lanes bit for bit; a tight box whose steps must stay
   inside it;
5. rmpc: the RMPC whole-solve kernel against its plain version at B=4096,
   N=20, 6 iterations x 4 alphas x 3 AL rounds, on ragged batches (B=4000
   and B=37), at N=6, and with 6 alphas (two chunks of the kernel's 4
   threads per lane), float64 and float32; twice the same call must agree
   bit for bit; one lane with NaN theta among valid lanes must report NaN
   and leave every other lane as it was;
6. main: `PMPCBatch` in closed loop with the analytic RK4 plant for 1200
   steps (2.4 s simulated) at B=4096 in float32, gated on finite controls,
   kernel launches and success within 1 cm; then 3 chained warm rounds and
   the projected-gradient certificate;
7. fallback: `PMPCBatch(use_kernel=False)` (solve_batch_fast, whose
   backward pass is the Riccati kernel) in the same closed loop, gated the
   same; then a few steps at B=4000, off the kernel's 128-lane grid;
8. rmpc-main: `RMPCBatch` at its production settings (N=20, 6x4x3, per-lane
   rescue on) in closed loop for 2500 steps (5 s simulated) at B=4096 in
   float32 against a plant with friction the nominal model lacks, gated on
   the control bounds, certificates, kernel launches and success within
   1 cm;
9. rescue: a starved kernel budget on stiff lanes at B=4096, N=20, with
   and without the per-lane `ilqr.solve_batch` rescue;
10. lmpc: the LMPC whole-solve kernel against its plain version at B=4096,
   N=6, 12 and 20, 2 iterations x 3 alphas, on ragged batches (B=4000 and
   B=37), and with 6 alphas (in chunks of the alphas one axis's threads run
   at once) on stiffer friction, float64 and float32, random 34-vectors and
   warm starts partly outside the box; twice the same call must agree bit
   for bit; one lane with a NaN 34-vector among valid lanes must report NaN
   and leave every other lane as it was;
11. lmpc-main: `LMPCBatch(N=12, dt=0.01)` with its 2x3 kernel budget and
   escalation in closed loop with the RK4 LMPC plant for 1024 steps (10.24
   s simulated) at B=4096 in float32, from rest, per-lane plant parameters
   and targets from `adapt.lmpc_trainer`'s samplers (the controller's
   34-vector equals the plant's), gated on finite controls, the tilt bound,
   kernel launches, the lanes left at rest being the kernel's fixed points
   from rest, and success within 1 cm (LMPC_SUCCESS_*);
12. lmpc-fallback: `LMPCBatch(use_kernel=False)` at B=4000 for a few steps,
   closed-form and autodiff linearisation, on the Riccati kernel at nz=10;
13. pmpc-eval: `make_pmpc_batch_evaluator()` at its defaults on the
   calibrated tray-object contact plant for 2500 steps (5 s simulated) at
   B=4096 in float32, rows from `random_scenarios(default_rng(0), 4096)`,
   gated on finite controls within |u| <= 0.6 + 1e-6, >= 450 `pmpc_solve`
   launches and no call of its plain version; prints success within 1 cm,
   the lanes that toppled or left the tray, and the times per plant step
   and per control step;
14. rmpc-eval: `make_rmpc_batch_evaluator()` on the same rows, 2500
   steps with the per-lane rescue off, gated on finite controls within
   |u| <= 0.4 + 1e-6 and >= 450 `rmpc_solve` launches, printing the same
   and the lanes the kernel leaves flagged at each control step; then at
   its defaults (rescue on) for its first 265 steps, printing the
   rescue's lanes and seconds (the defaults over 2500 steps take ~1 h on
   the card, out of the time limit);
15. sweep: the CLI `python -m dart_tpu_torch.cli.sweep --controller rmpc
   --batch_major --runtime 10` (18 rows padded to 128) on the legacy and on
   the calibrated lag, each gated on converging as many rows as JAX's own
   batch evaluator does on the CPU (JAX_SWEEP), rows printed beside JAX's;
16. times (printed, not gated): each kernel and its plain version per call
   (CUDA events), each kernel's device time per launch (torch.profiler),
   the closed-loop steps (host clock), and each kernel's launch geometry
   (threads, lanes and shared bytes per block, resident blocks per SM).
`profile`, run only when named, traces closed-loop steps with
torch.profiler and prints the device busy time per step and its rows;
`scan`, likewise, prints the Riccati and PMPC kernels' device time per
launch against horizon, budget and batch.
The last three lines are the card, the kernels' JSON record and the device
JSON.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

# Published H100 SXM peaks for the roofline bound: float32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

B = 4096            # scenarios per card, as the bench runs them
N = 15              # reference horizon
DT = 0.002          # 2 ms control period
ITERS, ALPHAS = 2, 3    # warm kernel budget
STEPS = 1200        # closed-loop steps (2.4 s simulated)
TOL_GRAD = 5e-3     # PMPCBatch.kernel_tol_grad

# Kernel vs plain tolerances.
# float64: the two differ only by FMA contraction in the kernel (~1 ulp per
# operation), so V and gnorm agree far inside 1e-9 and cost to 1e-11
# relative unless a box-QP active set flips on a near tie.
F64_TOL = {"V": 1e-9, "V_p99": 1e-9, "cost_rel": 1e-11, "gnorm": 1e-9}
# float32: FMA contraction and sinf/cosf against PyTorch's own sin/cos give
# differences of a few ulps per operation, carried through two Newton
# iterations. Where a lane's line search meets a near tie (c_new against
# cost - 1e-12) the two may accept different alphas, so the max over 4096
# lanes is bounded loosely and the bulk tightly, as
# tests/test_pmpc_solve_kernel.py:40-43 does (cost rtol 5e-3 + atol 1e-4,
# 99th percentile of |dV0| < 5e-3); every limit here is tighter.
F32_TOL = {"V": 1e-2, "V_p99": 1e-4, "cost_rel": 1e-4, "gnorm": 1e-3}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"[device] {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; nvidia-smi: {card}")
    print(f"[device] matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return card


def phase_build() -> None:
    from dart_tpu_torch.ops.kernels import _build

    lib, seconds, log = _build.build()
    _build.library()
    print(f"[build] {lib.relative_to(_build.PKG_DIR.parent)} in "
          f"{seconds:.2f} s")
    for line in log.splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or line.startswith("==")):
            print(f"[build] {line.strip()}")


def scenario(dtype: torch.dtype, dev: torch.device):
    """Targets, friction and start states as the bench draws them
    (bench.py:160-167), z0 ~ N(0, 0.02^2)."""
    rng = np.random.default_rng(0)
    targets = rng.uniform(-0.1, 0.1, size=(B, 6)) * \
        np.array([1, 0, 1, 0, 0, 0])
    mus = rng.uniform(0.05, 0.2, size=(B,))
    z0 = rng.normal(size=(B, 6)) * 0.02

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    return t(targets), t(mus), t(z0)


def kernel_inputs(dtype: torch.dtype, dev: torch.device):
    """Batch-last inputs of one warm-budget `pmpc_solve`, cold start."""
    from dart_tpu_torch.solver import pmpc_fast

    targets, mus, z0 = scenario(dtype, dev)
    Ad, Sd = pmpc_fast._affine_discretization(mus, -9.81, DT)
    wdiag = torch.zeros((B, 6), dtype=dtype, device=dev)
    wdiag[:, [0, 2]] = 300.0
    wdiag[:, [1, 3]] = 2.0
    rw = torch.full((B,), 0.2, dtype=dtype, device=dev)
    V0 = torch.zeros((B, N, 2), dtype=dtype, device=dev)
    bl = pmpc_fast._batch_last
    return [bl(Ad), bl(Sd), bl(wdiag), rw, bl(targets), bl(z0), bl(V0)]


PMPC_RAGGED = 37   # 4 blocks of 8 lanes and 5 more


def phase_kernel_vs_plain(dev: torch.device) -> float:
    """Returns the float32 max |dV| (the main path's working type)."""
    from dart_tpu_torch.ops.kernels.pmpc_solve import (pmpc_solve,
                                                       pmpc_solve_reference)

    kw = dict(dt=DT, u_bound=0.6, g=-9.81, n_iters=ITERS, n_alphas=ALPHAS)
    err32 = None
    for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, F32_TOL)):
        args = kernel_inputs(dtype, dev)
        V, cost, gn = pmpc_solve(*args, **kw)
        V_p, cost_p, gn_p = pmpc_solve_reference(*args, **kw)
        torch.cuda.synchronize()
        for name, x in (("V", V), ("cost", cost), ("gnorm", gn)):
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"kernel {name} not finite ({dtype})")
        dV = float((V - V_p).abs().max())
        dV99 = float(torch.quantile((V[0] - V_p[0]).abs().flatten()
                                    .double(), 0.99))
        dc = float(((cost - cost_p).abs() / (1 + cost_p.abs())).max())
        dg = float((gn - gn_p).abs().max())
        name = str(dtype).replace("torch.", "")
        print(f"[kernel-vs-plain] {name}: max|dV| {dV:.3e} (limit "
              f"{tol['V']:.0e}), p99|dV0| {dV99:.3e} (limit "
              f"{tol['V_p99']:.0e}), max|dcost|/(1+|cost|) {dc:.3e} (limit "
              f"{tol['cost_rel']:.0e}), max|dgnorm| {dg:.3e} (limit "
              f"{tol['gnorm']:.0e})")
        if (dV > tol["V"] or dV99 > tol["V_p99"] or dc > tol["cost_rel"]
                or dg > tol["gnorm"]):
            raise AssertionError(f"kernel disagrees with plain in {name}")
        if float(V.abs().max()) > 0.6 + 1e-6:
            raise AssertionError("kernel V outside the box")
        again = pmpc_solve(*args, **kw)
        if not all(bool(torch.equal(x, y)) for x, y in zip((V, cost, gn),
                                                           again)):
            raise AssertionError(f"pmpc kernel not deterministic ({name})")
        # A ragged batch: its lanes must come out as the same lanes of the
        # full batch, bit for bit (a lane's work does not depend on B).
        sub = pmpc_solve(*(a[..., :PMPC_RAGGED].contiguous() for a in args),
                         **kw)
        same = all(bool(torch.equal(x, y[..., :PMPC_RAGGED]))
                   for x, y in zip(sub, (V, cost, gn)))
        print(f"[kernel-vs-plain] {name}: a second call bit for bit: True; "
              f"B={PMPC_RAGGED} as the first {PMPC_RAGGED} lanes of B={B}: "
              f"{same}")
        if not same:
            raise AssertionError(f"pmpc kernel at B={PMPC_RAGGED} differs "
                                 f"from the full batch ({name})")
        if dtype == torch.float32:
            err32 = dV

    # One lane whose Ad breaks the sparsity the kernel assumes.
    args = kernel_inputs(torch.float32, dev)
    args[0] = args[0].clone()
    args[0][0, 3, 0] = 0.01
    _, cost, gn = pmpc_solve(*args, **kw)
    ok = (not bool(torch.isfinite(cost[0])) and not bool(torch.isfinite(gn[0]))
          and bool(torch.isfinite(cost[1:]).all())
          and bool(torch.isfinite(gn[1:]).all()))
    print(f"[kernel-vs-plain] broken-structure lane 0: cost {float(cost[0])}, "
          f"gnorm {float(gn[0])}; other lanes finite: "
          f"{bool(torch.isfinite(cost[1:]).all())}")
    if not ok:
        raise AssertionError("structure guard did not poison lane 0 alone")

    # A horizon without a kernel instance is refused before any launch.
    launches = pmpc_solve.launches
    try:
        pmpc_solve(*(a[..., :128].contiguous() for a in args[:6]),
                   torch.zeros((8, 2, 128), dtype=torch.float32, device=dev),
                   **kw)
    except NotImplementedError as e:
        print(f"[kernel-vs-plain] N=8 refused: {e}")
    else:
        raise AssertionError("N=8 launched although the kernel has no "
                             "instance for it")
    if pmpc_solve.launches != launches:
        raise AssertionError("a refused call counted a launch")
    return err32


def main_path_setup(dev: torch.device):
    from dart_tpu_torch.control import mpc
    from dart_tpu_torch.models import dynamics as dyn
    from dart_tpu_torch.rollout import loop

    targets, mus, _ = scenario(torch.float32, dev)
    ctlr = mpc.PMPCBatch(N=N, dt=DT)
    weights = mpc.PMPCWeights(300.0, 2.0, 0.2)
    params = dyn.PMPCParams(mu=mus, dt=DT)
    plant = loop.pmpc_plant_step(mus, DT)
    return ctlr, targets, mus, weights, params, plant


def phase_main_path(dev: torch.device, card: str) -> int:
    from dart_tpu_torch.ops.kernels.pmpc_solve import pmpc_solve
    from dart_tpu_torch.rollout import loop
    from dart_tpu_torch.solver import ilqr, pmpc_fast
    from dart_tpu_torch.solver.ocp import PMPCAux

    ctlr, targets, mus, weights, params, plant = main_path_setup(dev)
    rounds = []

    def solve_fn(carry, x):
        carry, u, diag = ctlr.solve(carry, x, targets, params, weights)
        rounds.append(diag.iters[0])
        return carry, u

    x0 = torch.zeros((B, 6), dtype=torch.float32, device=dev)
    carry0 = ctlr.init_carry(B, torch.float32, dev)
    pmpc_solve.launches = 0
    t0 = time.perf_counter()
    carry, xf, us = loop.run_batch_closed_loop(solve_fn, plant, carry0, x0,
                                               STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pmpc_solve.launches
    extra = (torch.stack(rounds).cpu().numpy() // ctlr.kernel_iters) - 1
    success, err_mm = loop.quality_at_1cm(xf, targets)
    print(f"[main-path] {STEPS} steps at B={B}, N={N}, float32: "
          f"{launches} kernel launches, {wall:.3f} s wall; escalation "
          f"rounds: total {int(extra.sum())}, steps escalated "
          f"{int((extra > 0).sum())}, max {int(extra.max())} [{card}]")
    print(f"[main-path] success@1cm {success:.4f} (gate >= 0.99), mean final "
          f"error {err_mm:.4f} mm")
    if not bool(torch.isfinite(us).all()):
        raise AssertionError("non-finite controls on the main path")
    if launches < STEPS:
        raise AssertionError(f"only {launches} kernel launches in {STEPS} "
                             "steps: the main path did not use the kernel")
    if success < 0.99:
        raise AssertionError(f"success@1cm {success} < 0.99")

    # Converged budget: 3 chained warm rounds from the final state.
    aux = PMPCAux(target=targets, Qp=torch.full_like(mus, 300.0),
                  Qv=torch.full_like(mus, 2.0), R=torch.full_like(mus, 0.2))
    V = carry.V
    for _ in range(3):
        V, _, gn_k = pmpc_fast.solve_batch_kernel(mus, aux, xf, V, dt=DT,
                                                  n_iters=ITERS,
                                                  n_alphas=ALPHAS)
    pg = ilqr.projected_grad_norm(ctlr.ocp, params, aux, xf, V)
    pg_max = float(pg.max())
    print(f"[main-path] converged budget (3 x 2x3): projected_grad_norm max "
          f"{pg_max:.3e} (gate <= {TOL_GRAD:.0e}); kernel gnorm max "
          f"{float(gn_k.max()):.3e}")
    if not pg_max <= TOL_GRAD:
        raise AssertionError(f"projected gradient {pg_max} > {TOL_GRAD}")
    return launches


def median_ms(fn, reps: int) -> float:
    """Median over `reps` calls of CUDA-event time per call."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, reps: int, kernel: str) -> float:
    """Mean device time in ms of one launch of `<kernel>_kernel`, from
    torch.profiler over `reps` calls of `fn`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and f"{kernel}_kernel<" in e.name]
    return sum(us) / len(us) / 1e3 if us else float("nan")


def bound(flops: int, nbytes: int) -> tuple[float, str]:
    """The least time in ms the card could take for this work, and which
    side bounds it."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_times(dev: torch.device, card: str) -> dict:
    from dart_tpu_torch.ops.kernels import pmpc_solve as kps
    from dart_tpu_torch.ops.kernels.pmpc_solve import (pmpc_solve,
                                                       pmpc_solve_reference)
    from dart_tpu_torch.rollout import loop

    args = kernel_inputs(torch.float32, dev)
    kw = dict(dt=DT, n_iters=ITERS, n_alphas=ALPHAS)
    for _ in range(3):
        pmpc_solve(*args, **kw)
        pmpc_solve_reference(*args, **kw)
    torch.cuda.synchronize()
    ms = median_ms(lambda: pmpc_solve(*args, **kw), 20)
    plain_ms = median_ms(lambda: pmpc_solve_reference(*args, **kw), 10)
    dev_ms = device_ms(lambda: pmpc_solve(*args, **kw), 20, "pmpc_solve")
    stats = {}
    pmpc_solve_reference(*args, **kw, stats=stats)
    trials = int(stats["trials"].sum())
    w_nz = (args[2] != 0).any(dim=1).tolist()
    flops, nbytes = kps.work(N, ITERS, B, trials, 4, w_nz)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[times] pmpc_solve B={B} N={N} {ITERS}x{ALPHAS} float32, median "
          f"per call: kernel {ms:.4f} ms ({B / ms * 1e3:.4g} solves/s), "
          f"plain {plain_ms:.2f} ms ({B / plain_ms * 1e3:.4g} solves/s); "
          f"device per launch (profiler) {dev_ms:.4f} ms [{card}]")
    print(f"[times] pmpc_solve work: {flops} FLOPs ({trials} line-search "
          f"trials), {nbytes} bytes; bound {bound_ms:.6f} ms by {bound_by}")
    print_geometry("pmpc_solve", kps.launch_geometry, N)

    ctlr, targets, _, weights, params, plant = main_path_setup(dev)
    solve_fn = loop.pmpc_solve_fn(ctlr, targets, params, weights)
    x0 = torch.zeros((B, 6), dtype=torch.float32, device=dev)
    carry, x, _ = loop.run_batch_closed_loop(
        solve_fn, plant, ctlr.init_carry(B, torch.float32, dev), x0, 50)
    steps = 200
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.run_batch_closed_loop(solve_fn, plant, carry, x, steps)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    print(f"[times] closed-loop PMPCBatch step (steps 50-250, host clock): "
          f"{step_ms:.4f} ms/step ({B / step_ms * 1e3:.4g} solves/s) "
          f"[{card}]")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


# ---------------------------------------------------------------------------
# Riccati backward kernel
# ---------------------------------------------------------------------------

# Kernel vs plain tolerances. Both evaluate the same expressions in the same
# order; they differ by FMA contraction in the kernel (~1 ulp per operation).
# float64: far inside 1e-10 on D and K.
RIC_F64_TOL = {"D": 1e-10, "K": 1e-10}
# float32: a few ulps per operation, carried through N stages of the value
# recursion. The 9-way box QP tests KKT signs at 1e-9, below float32's
# resolution, so at a near tie the two may pick different active sets and
# a lane's D and the rows of K its free set zeroes differ at O(1): the
# bulk is held at tests/test_pallas_riccati.py's D 2e-5 / K 2e-4 (99th
# percentile over every entry), and at most 0.5% of lanes may differ more.
RIC_F32_TOL = {"D_p99": 2e-5, "K_p99": 2e-4, "lanes_off": 0.005}


def riccati_problem(seed: int, N_: int, nz: int, dtype: torch.dtype,
                    dev: torch.device, box: float = 0.6):
    """Batch-last inputs made as tests/test_pallas_riccati.py:16-35 makes
    them, with a per-lane reg. V is clipped into the box."""
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return rng.normal(size=shape) * 0.1

    eye = np.eye(nz)
    A = mk(B, N_, nz, nz) + eye
    Bm = mk(B, N_, nz, 2)
    lx = mk(B, N_, nz)
    lu = mk(B, N_, 2)
    h = mk(B, N_, nz, nz)
    lxx = np.einsum("bnij,bnkj->bnik", h, h) + 2 * eye
    lux = mk(B, N_, 2, nz) * 0.1
    h2 = mk(B, N_, 2, 2)
    luu = np.einsum("bnij,bnkj->bnik", h2, h2) + 0.5 * np.eye(2)
    gx = mk(B, nz)
    h3 = mk(B, nz, nz)
    gxx = np.einsum("bij,bkj->bik", h3, h3) + eye
    V = np.clip(mk(B, N_, 2), -box, box)
    reg = rng.uniform(1e-7, 1e-5, size=B)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(np.moveaxis(x, 0, -1)),
                               dtype=dtype, device=dev)

    args = [t(x) for x in (A, Bm, lx, lu, lxx, lux, luu, gx, gxx, V)]
    return args, (-box, -box), (box, box), torch.as_tensor(
        reg, dtype=dtype, device=dev)


def riccati_ragged(args, lo, hi, reg, full, label: str) -> None:
    """A second call at B=4096 must agree bit for bit, and ragged batches
    (B=4000 and B=37, the first lanes of the same problem) must give the
    full batch's lanes bit for bit (a lane's work does not depend on B);
    the full batch is held to the plain version above."""
    from dart_tpu_torch.ops.kernels.riccati import riccati_backward

    again = riccati_backward(*args, lo, hi, reg)
    if not all(bool(torch.equal(x, y)) for x, y in zip(full, again)):
        raise AssertionError(f"riccati kernel not deterministic ({label})")
    for Bp in (4000, 37):
        sub = riccati_backward(*(a[..., :Bp].contiguous() for a in args), lo,
                               hi, reg[:Bp].contiguous())
        if not all(bool(torch.equal(x, y[..., :Bp]))
                   for x, y in zip(sub, full)):
            raise AssertionError(f"riccati kernel at B={Bp} differs from the "
                                 f"full batch ({label})")
    print(f"[riccati] {label}: a second call bit for bit, and B=4000 and "
          f"B=37 as the full batch's first lanes, bit for bit")


def phase_riccati(dev: torch.device) -> float:
    """Returns the float32 max |dD| at the main path's shape (nz=6, N=20
    is what the time phase measures; every case must pass)."""
    from dart_tpu_torch.ops.kernels.riccati import (
        riccati_backward, riccati_backward_reference)

    err32 = 0.0
    for nz, N_ in ((6, 15), (6, 20), (10, 20)):
        for dtype in (torch.float64, torch.float32):
            args, lo, hi, reg = riccati_problem(nz * 100 + N_, N_, nz,
                                                dtype, dev)
            D, K = riccati_backward(*args, lo, hi, reg)
            D_p, K_p = riccati_backward_reference(*args, lo, hi, reg)
            torch.cuda.synchronize()
            if not (bool(torch.isfinite(D).all())
                    and bool(torch.isfinite(K).all())):
                raise AssertionError(f"riccati nz={nz} N={N_} {dtype}: "
                                     "kernel output not finite")
            dD, dK = (D - D_p).abs(), (K - K_p).abs()
            name = str(dtype).replace("torch.", "")
            if N_ == 20:
                riccati_ragged(args, lo, hi, reg, (D, K),
                               f"nz={nz} N={N_} {name}")
            msg = (f"[riccati] nz={nz} N={N_} {name}: max|dD| "
                   f"{float(dD.max()):.3e}, max|dK| {float(dK.max()):.3e}")
            if dtype == torch.float64:
                print(msg + f" (limits {RIC_F64_TOL['D']:.0e}, "
                      f"{RIC_F64_TOL['K']:.0e})")
                if (float(dD.max()) > RIC_F64_TOL["D"]
                        or float(dK.max()) > RIC_F64_TOL["K"]):
                    raise AssertionError(f"riccati disagrees with plain "
                                         f"(nz={nz}, N={N_}, float64)")
                continue
            D99 = float(torch.quantile(dD.flatten().double()[:2 ** 24],
                                       0.99))
            K99 = float(torch.quantile(dK.flatten().double()[:2 ** 24],
                                       0.99))
            lane_d = torch.maximum(dD.amax(dim=(0, 1)), dK.amax(dim=(0, 1, 2)))
            off = float((lane_d > RIC_F32_TOL["K_p99"]).double().mean())
            print(msg + f", p99|dD| {D99:.3e} (limit "
                  f"{RIC_F32_TOL['D_p99']:.0e}), p99|dK| {K99:.3e} (limit "
                  f"{RIC_F32_TOL['K_p99']:.0e}), lanes off by > "
                  f"{RIC_F32_TOL['K_p99']:.0e}: {off:.4%} (limit "
                  f"{RIC_F32_TOL['lanes_off']:.1%})")
            if (D99 > RIC_F32_TOL["D_p99"] or K99 > RIC_F32_TOL["K_p99"]
                    or off > RIC_F32_TOL["lanes_off"]):
                raise AssertionError(f"riccati disagrees with plain "
                                     f"(nz={nz}, N={N_}, float32)")
            if (nz, N_) == (6, 20):
                err32 = float(torch.maximum(dD.max(), dK.max()))

    # Tight box: many active constraints; V + D must stay inside it.
    for dtype in (torch.float64, torch.float32):
        args, lo, hi, reg = riccati_problem(7, 20, 6, dtype, dev, box=0.05)
        D, K = riccati_backward(*args, lo, hi, reg)
        D_p, _ = riccati_backward_reference(*args, lo, hi, reg)
        Vn = args[-1] + D
        worst = float((Vn.abs() - 0.05).max())
        active = float((Vn.abs() > 0.05 - 1e-6).double().mean())
        print(f"[riccati] box 0.05, {str(dtype)[6:]}: max(|V+D| - 0.05) "
              f"{worst:.3e} (limit 1e-6), share of steps at a bound "
              f"{active:.3f}, max|dD| vs plain {float((D - D_p).abs().max()):.3e}")
        if worst > 1e-6:
            raise AssertionError("riccati step leaves the box")
    return err32


# ---------------------------------------------------------------------------
# RMPC whole-solve kernel
# ---------------------------------------------------------------------------

RMPC_N = 20
RMPC_BUDGET = dict(n_iters=6, n_alphas=4, al_rounds=3)
RMPC_KW = dict(dt=DT, u_bound=0.4, du_bound=0.05, vmax=0.25, v_eps=0.1,
               mu_init=10.0, mu_scale=10.0, mu_max=1e8, tol_con=1e-8,
               **RMPC_BUDGET)
# float64: FMA contraction only (~1 ulp per operation); a line-search or
# box-QP tie is improbable at this resolution.
RMPC_F64_TOL = {"V": 1e-9, "cost_rel": 1e-10, "viol": 1e-9, "gnorm": 1e-9}
# float32: a few ulps per operation through 18 Newton iterations. The line
# search accepts on c_new < cost - 1e-12, far below float32's resolution, so
# at a near tie a lane may accept another alpha and take a different (as
# good) path: the max is bounded by tests/test_rmpc_solve_kernel.py's
# kernel-vs-generic limits (cost rtol 5e-3, viol atol 1e-4), the bulk
# tightly (99th percentile of |dV0| 1e-4, against that test's 2e-3).
RMPC_F32_TOL = {"V_p99": 1e-4, "V": 5e-2, "cost_rel": 5e-3, "viol": 1e-4,
                "gnorm": 5e-2}


def rmpc_problem(seed: int, dtype: torch.dtype, dev: torch.device,
                 N_: int = RMPC_N):
    """Batch-last inputs of one `rmpc_solve`: estimates and references as
    tests/test_rmpc_solve_kernel.py makes them, a quarter of the lanes
    starting near or past the velocity caps and an eighth on a tilt bound
    (so the AL rows and the clip mask are exercised), a random warm start
    partly outside +-du_bound."""
    from dart_tpu_torch.control.reference import build_ref_traj

    rng = np.random.default_rng(seed)
    thetas = rng.normal(size=(B, 14)) * 0.3
    states = rng.normal(size=(B, 4)) * 0.05
    q = B // 4
    states[:q, 1] = rng.uniform(-0.3, 0.3, q)
    states[:q, 3] = rng.uniform(-0.3, 0.3, q)
    up0 = rng.uniform(-0.1, 0.1, (B, 2))
    up0[q:q + B // 8] = rng.choice([-0.4, 0.4], size=(B // 8, 2))
    tmask = np.array([1.0, 0.0, 1.0, 0.0])
    targets = rng.uniform(-0.08, 0.08, (B, 4)) * tmask
    refs = build_ref_traj(torch.as_tensor(states * tmask),
                          torch.as_tensor(targets), N_, 0.2).numpy()
    z0 = np.concatenate([states, up0], -1)
    V0 = rng.uniform(-0.08, 0.08, (B, N_, 2))
    w = np.stack([np.full(B, v) for v in (100.0, 1.0, 0.05, 1.0)])

    def t(x, last=True):
        x = np.moveaxis(x, 0, -1) if last else x
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=dev)

    return [t(thetas), t(refs), t(w, last=False), t(z0), t(V0)]


def _rmpc_check(label: str, got, want, tol: dict) -> float:
    """Hold one kernel result to its plain version; returns max |dV|."""
    V, cost, viol, gn = got
    V_p, cost_p, viol_p, gn_p = want
    for nm, x in (("V", V), ("cost", cost), ("viol", viol), ("gnorm", gn)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"rmpc kernel {nm} not finite ({label})")
    dV = float((V - V_p).abs().max())
    dV99 = float(torch.quantile((V[0] - V_p[0]).abs().flatten().double(),
                                0.99))
    dc = float(((cost - cost_p).abs() / (1 + cost_p.abs())).max())
    dvl = float((viol - viol_p).abs().max())
    dg = float((gn - gn_p).abs().max())
    print(f"[rmpc] {label}: max|dV| {dV:.3e} (limit {tol['V']:.0e}), "
          + (f"p99|dV0| {dV99:.3e} (limit {tol['V_p99']:.0e}), "
             if "V_p99" in tol else "")
          + f"max|dcost|/(1+|cost|) {dc:.3e} (limit {tol['cost_rel']:.0e}), "
          f"max|dviol| {dvl:.3e} (limit {tol['viol']:.0e}), max|dgnorm| "
          f"{dg:.3e} (limit {tol['gnorm']:.0e}); lanes with viol > 0: "
          f"{int((viol > 0).sum())}, max viol {float(viol.max()):.3e}, "
          f"max gnorm {float(gn.max()):.3e}")
    if (dV > tol["V"] or dV99 > tol.get("V_p99", tol["V"])
            or dc > tol["cost_rel"] or dvl > tol["viol"] or dg > tol["gnorm"]):
        raise AssertionError(f"rmpc kernel disagrees with plain in {label}")
    if float(V.abs().max()) > 0.05 + 1e-6:
        raise AssertionError(f"rmpc kernel V outside +-du_bound ({label})")
    return dV


# A budget with more alphas than the kernel's 4 threads per lane, so the
# line search runs them in two chunks and must keep the first-accept order.
RMPC_KW_CHUNKED = {**RMPC_KW, "n_iters": 2, "n_alphas": 6, "al_rounds": 2}
RMPC_NAN_LANE = 13   # second block's sixth lane: not a block's first


def phase_rmpc(dev: torch.device) -> float:
    """The kernel against its plain version at the main path's shape (N=20,
    B=4096, 6x4x3), on ragged batches (B=4000 and B=37, the first lanes of
    the same problem: the plain version is lane by lane, so its B=4096
    result holds for them), at N=6, and with 6 alphas in two chunks, in
    float64 and float32; a NaN lane among valid ones; a horizon without an
    instance. Returns the float32 max |dV| at the main path's shape."""
    from dart_tpu_torch.ops.kernels.rmpc_solve import (rmpc_solve,
                                                       rmpc_solve_reference)

    err32, clean32 = None, None
    for dtype, tol in ((torch.float64, RMPC_F64_TOL),
                       (torch.float32, RMPC_F32_TOL)):
        name = str(dtype).replace("torch.", "")
        args = rmpc_problem(3, dtype, dev)
        got = rmpc_solve(*args, **RMPC_KW)
        want = rmpc_solve_reference(*args, **RMPC_KW)
        dV = _rmpc_check(f"{name} N=20 B={B}", got, want, tol)
        again = rmpc_solve(*args, **RMPC_KW)
        if not all(bool(torch.equal(x, y)) for x, y in zip(got, again)):
            raise AssertionError(f"rmpc kernel not deterministic ({name})")
        for Bp in (4000, 37):
            sub = [a[..., :Bp].contiguous() for a in args]
            _rmpc_check(f"{name} N=20 B={Bp}", rmpc_solve(*sub, **RMPC_KW),
                        [w[..., :Bp] for w in want], tol)
        args6 = rmpc_problem(4, dtype, dev, N_=6)
        _rmpc_check(f"{name} N=6 B={B}", rmpc_solve(*args6, **RMPC_KW),
                    rmpc_solve_reference(*args6, **RMPC_KW), tol)
        want6a = rmpc_solve_reference(*args, **RMPC_KW_CHUNKED)
        _rmpc_check(f"{name} N=20 B={B} 2x6x2", rmpc_solve(
            *args, **RMPC_KW_CHUNKED), want6a, tol)
        if dtype == torch.float64:
            # Lanes whose plain result moves when alphas 5 and 6 are offered
            # took one of them: the second chunk decided something there.
            want4a = rmpc_solve_reference(
                *args, **{**RMPC_KW_CHUNKED, "n_alphas": 4})
            late = int((want6a[0] != want4a[0]).flatten(0, 1).any(0).sum())
            print(f"[rmpc] 2x6x2: {late} lanes accept an alpha past the "
                  f"first 4 in the plain version")
            if late == 0:
                raise AssertionError("no lane reached the second chunk of "
                                     "alphas: the 2x6x2 case tests nothing")
        else:
            err32, clean32 = dV, got

    # One lane with NaN theta, among valid lanes, must report NaN; every
    # other lane must come out as it did without it.
    args = rmpc_problem(3, torch.float32, dev)
    args[0][:, RMPC_NAN_LANE] = float("nan")
    got = rmpc_solve(*args, **RMPC_KW)
    rest = torch.ones(B, dtype=torch.bool, device=dev)
    rest[RMPC_NAN_LANE] = False
    bad = (bool(torch.isnan(got[2][RMPC_NAN_LANE]))
           or bool(torch.isnan(got[3][RMPC_NAN_LANE])))
    same = all(bool(torch.equal(x[..., rest], y[..., rest]))
               for x, y in zip(got, clean32))
    print(f"[rmpc] NaN-theta lane {RMPC_NAN_LANE}: viol "
          f"{float(got[2][RMPC_NAN_LANE])}, gnorm "
          f"{float(got[3][RMPC_NAN_LANE])}; lanes {RMPC_NAN_LANE - 1} and "
          f"{RMPC_NAN_LANE + 1} cost {float(got[1][RMPC_NAN_LANE - 1]):.6g}, "
          f"{float(got[1][RMPC_NAN_LANE + 1]):.6g}; every other lane as "
          f"without it: {same}")
    if not (bad and same):
        raise AssertionError("NaN lane not reported, or it leaked")

    # A horizon without a kernel instance is refused before any launch.
    launches = rmpc_solve.launches
    try:
        rmpc_solve(*rmpc_problem(3, torch.float32, dev, N_=8), **RMPC_KW)
    except NotImplementedError as e:
        print(f"[rmpc] N=8 refused: {e}")
    else:
        raise AssertionError("N=8 launched without a kernel instance")
    if rmpc_solve.launches != launches:
        raise AssertionError("a refused call counted a launch")
    return err32


# ---------------------------------------------------------------------------
# PMPC branches on the Riccati kernel
# ---------------------------------------------------------------------------

def phase_fallback(dev: torch.device, card: str) -> dict:
    from dart_tpu_torch.control import mpc
    from dart_tpu_torch.ops.kernels.riccati import riccati_backward
    from dart_tpu_torch.rollout import loop

    _, targets, mus, weights, params, plant = main_path_setup(dev)
    ctlr = mpc.PMPCBatch(N=N, dt=DT, use_kernel=False)
    solve_fn = loop.pmpc_solve_fn(ctlr, targets, params, weights)
    x0 = torch.zeros((B, 6), dtype=torch.float32, device=dev)
    warm = STEPS // 6
    riccati_backward.launches = 0
    t0 = time.perf_counter()
    carry, x, us = loop.run_batch_closed_loop(
        solve_fn, plant, ctlr.init_carry(B, torch.float32, dev), x0, warm)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    carry, xf, us2 = loop.run_batch_closed_loop(solve_fn, plant, carry, x,
                                                STEPS - warm)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = riccati_backward.launches
    step_ms = (t2 - t1) / (STEPS - warm) * 1e3
    success, err_mm = loop.quality_at_1cm(xf, targets)
    print(f"[fallback] PMPCBatch(use_kernel=False) {STEPS} steps at B={B}, "
          f"N={N}, float32: {launches} Riccati launches, "
          f"{t2 - t0:.3f} s wall, {step_ms:.4f} ms/step over steps "
          f"{warm}-{STEPS} (host clock) [{card}]")
    print(f"[fallback] success@1cm {success:.4f} (gate >= 0.99), mean final "
          f"error {err_mm:.4f} mm")
    if not (bool(torch.isfinite(us).all()) and bool(torch.isfinite(us2).all())):
        raise AssertionError("non-finite controls on the fallback path")
    if launches < STEPS:
        raise AssertionError(f"only {launches} Riccati launches in {STEPS} "
                             "steps")
    if success < 0.99:
        raise AssertionError(f"fallback success@1cm {success} < 0.99")

    # Off the kernel's grid: B = 4000 takes solve_batch_fast even with the
    # whole-solve kernel allowed.
    B2 = B - 96             # 4000 at B=4096: off the 128-lane grid
    ctlr2 = mpc.PMPCBatch(N=N, dt=DT)
    fn2 = loop.pmpc_solve_fn(ctlr2, targets[:B2],
                             params._replace(mu=params.mu[:B2]), weights)
    plant2 = loop.pmpc_plant_step(mus[:B2], DT)
    before = riccati_backward.launches
    _, _, us3 = loop.run_batch_closed_loop(
        fn2, plant2, ctlr2.init_carry(B2, torch.float32, dev),
        torch.zeros((B2, 6), dtype=torch.float32, device=dev), 5)
    n2 = riccati_backward.launches - before
    print(f"[fallback] B={B2}: 5 steps, {n2} Riccati launches")
    if n2 < 5 or not bool(torch.isfinite(us3).all()):
        raise AssertionError("B=4000 did not run on the Riccati kernel")
    return {"launches": launches, "step_ms": step_ms}


# ---------------------------------------------------------------------------
# RMPC main path
# ---------------------------------------------------------------------------

RMPC_STEPS = 2500   # 5 s simulated, make_rmpc_batch_evaluator's n_steps
RMPC_TOL_GRAD = 5e-3
# Steps from rest in which a lane may stay uncertified. In the first steps
# the RLS estimate rests on a few samples and can put positive velocity
# feedback on a lane that no solve holds under the velocity caps: at step 3
# JAX's own RMPCBatch leaves the same lanes infeasible with the same
# violation (tests/test_torch_rmpc_batch.py::
# test_rls_transient_is_infeasible_in_jax_too). From this step on, every
# lane must be certified after every step.
RMPC_TRANSIENT = 10


def rmpc_controller(**over):
    from dart_tpu_torch.control import mpc
    from dart_tpu_torch.solver import ilqr

    kw = dict(N=RMPC_N, dt=DT, u_bound=0.4, du_bound=0.05, vmax=0.25,
              cfg=ilqr.ILQRConfig(max_iters=10, al_iters=3),
              kernel_iters=6, kernel_alphas=4, kernel_al_rounds=3,
              kernel_max_extra_rounds=2, kernel_tol_grad=RMPC_TOL_GRAD,
              kernel_xla_fallback=True)
    kw.update(over)
    return mpc.RMPCBatch(**kw)


def rmpc_scenario(dev: torch.device):
    """Plant friction mu ~ U(0.05, 0.2) (the nominal model, theta = 0, has
    none) and targets ~ U(-0.1, 0.1) m on x and y, float32."""
    rng = np.random.default_rng(1)
    mus = torch.as_tensor(rng.uniform(0.05, 0.2, size=B), dtype=torch.float32,
                          device=dev)
    t4 = np.zeros((B, 4))
    t4[:, 0] = rng.uniform(-0.1, 0.1, B)
    t4[:, 2] = rng.uniform(-0.1, 0.1, B)
    return mus, torch.as_tensor(t4, dtype=torch.float32, device=dev)


def phase_rmpc_main(dev: torch.device, card: str) -> dict:
    from dart_tpu_torch.ops.kernels.riccati import riccati_backward
    from dart_tpu_torch.ops.kernels.rmpc_solve import rmpc_solve
    from dart_tpu_torch.rollout import loop
    from dart_tpu_torch.solver import ilqr

    mus, targets4 = rmpc_scenario(dev)
    plant = loop.pmpc_plant_step(mus, DT)
    ctlr = rmpc_controller()
    tol_con = ctlr.cfg.tol_con
    x = torch.zeros((B, 6), dtype=torch.float32, device=dev)
    carry = ctlr.init_carry_batch(x[:, :4])
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    nonfinite, umax, dumax = zero.clone(), zero.clone(), zero.clone()
    uncert, iters, rescue_steps = [], [], 0
    # The largest positive velocity-feedback estimate (theta on the tanh
    # features) among lanes left uncertified.
    feedback, viol_bad = zero.clone(), zero.clone()
    rmpc_solve.launches = 0
    riccati_backward.launches = 0
    syncs0 = ilqr.host_bool.count
    warm = RMPC_STEPS // 5
    t0 = t_mid = time.perf_counter()
    with torch.no_grad():
        for step in range(RMPC_STEPS):
            if step == warm:
                torch.cuda.synchronize()
                t_mid = time.perf_counter()
            r0 = riccati_backward.launches
            u_prev = carry.u_prev
            carry, u, diag = ctlr.solve_batched(carry, x[:, :4], targets4)
            rescue_steps += riccati_backward.launches > r0
            x = plant(x, u)
            nonfinite += (~torch.isfinite(u)).sum()
            umax = torch.maximum(umax, u.abs().amax())
            dumax = torch.maximum(dumax, (u - u_prev).abs().amax())
            bad = ~(diag.viol <= tol_con) | \
                ~(diag.grad_norm <= RMPC_TOL_GRAD)
            uncert.append(bad.sum())
            th = torch.cat([carry.rls_x.theta[:, 4:5],
                            carry.rls_y.theta[:, 5:6]], -1)
            feedback = torch.maximum(feedback, torch.where(
                bad[:, None], th, torch.zeros_like(th)).amax())
            viol_bad = torch.maximum(viol_bad, torch.where(
                bad, diag.viol, torch.zeros_like(diag.viol)).amax())
            iters.append(diag.iters[0])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = rmpc_solve.launches
    ric = riccati_backward.launches
    syncs = ilqr.host_bool.count - syncs0
    step_ms = (t1 - t_mid) / (RMPC_STEPS - warm) * 1e3
    extra = (torch.stack(iters).cpu().numpy()
             // (ctlr.kernel_iters * ctlr.kernel_al_rounds)) - 1
    success, err_mm = loop.quality_at_1cm(x, targets4)
    uncert = torch.stack(uncert).cpu().numpy()
    late = int(uncert[RMPC_TRANSIENT:].sum())
    hit = np.nonzero(uncert)[0]
    print(f"[rmpc-main] RMPCBatch {RMPC_STEPS} steps at B={B}, N={RMPC_N}, "
          f"6x4x3, float32: {launches} rmpc_solve launches, {t1 - t0:.3f} s "
          f"wall, {step_ms:.4f} ms/step over steps {warm}-{RMPC_STEPS} (host "
          f"clock) [{card}]")
    print(f"[rmpc-main] escalation rounds: total {int(extra.sum())}, steps "
          f"escalated {int((extra > 0).sum())}, max {int(extra.max())}; "
          f"rescue steps {rescue_steps}, Riccati launches {ric}; host syncs "
          f"{syncs}")
    print(f"[rmpc-main] max|u| {float(umax):.6f} (limit 0.4), max|du| "
          f"{float(dumax):.6f} (limit 0.05 + 1e-6), non-finite controls "
          f"{int(nonfinite)}")
    print(f"[rmpc-main] uncertified lane-steps: {int(uncert.sum())} in "
          f"{len(hit)} steps (first {hit[:1].tolist()}, last "
          f"{hit[-1:].tolist()}), {late} from step {RMPC_TRANSIENT} on "
          f"(gate 0); "
          f"largest velocity-feedback estimate among them "
          f"{float(feedback):.3f}, their largest viol after the rescue "
          f"{float(viol_bad):.3e}")
    print(f"[rmpc-main] success@1cm {success:.4f} (gate >= 0.99), mean final "
          f"error {err_mm:.4f} mm")
    if int(nonfinite) != 0:
        raise AssertionError("non-finite controls on the RMPC path")
    if float(umax) > 0.4 or float(dumax) > 0.05 + 1e-6:
        raise AssertionError("a control left its tilt or slew bound")
    if launches < RMPC_STEPS:
        raise AssertionError(f"only {launches} rmpc_solve launches in "
                             f"{RMPC_STEPS} steps")
    if late != 0:
        raise AssertionError(f"{late} lane-steps uncertified from step "
                             f"{RMPC_TRANSIENT} on")
    if success < 0.99:
        raise AssertionError(f"RMPC success@1cm {success} < 0.99")
    return {"launches": launches, "riccati": ric, "step_ms": step_ms}


def phase_rescue(dev: torch.device) -> int:
    """The starved-budget mechanism of tests/test_rmpc_kernel_rescue.py at
    B=4096, N=20. Returns the Riccati launches of the rescued solve."""
    from dart_tpu_torch.adapt.rls import RLSState
    from dart_tpu_torch.ops.kernels.riccati import riccati_backward

    rng = np.random.default_rng(7)
    states = rng.normal(size=(B, 4)) * 0.02
    targets = np.tile([0.112, 0.0, 0.06, 0.0], (B, 1))
    half = B // 2
    states[:half, 1] = 0.0
    states[:half, 3] = 0.0
    targets[:half] = states[:half]
    th = rng.normal(size=(B, 14)) * 0.3
    th[half:] = rng.normal(size=(half, 14)) * 0.2
    th[half:, 1] = -rng.uniform(10, 40, half)
    th[half:, 4] = -rng.uniform(2, 8, half)
    th[half:, 6] = rng.uniform(-1, 1, half)
    th[half:, 10] = -rng.uniform(10, 40, half)
    th[half:, 12] = -rng.uniform(2, 8, half)
    th[half:, 13] = rng.uniform(-1, 1, half)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    states, targets, th = t(states), t(targets), t(th)

    def run(fallback: bool):
        ctlr = rmpc_controller(kernel_iters=1, kernel_alphas=2,
                               kernel_al_rounds=1, kernel_max_extra_rounds=0,
                               kernel_xla_fallback=fallback)
        carry = ctlr.init_carry_batch(states)
        carry = carry._replace(
            rls_x=RLSState(theta=th[:, :7], P=carry.rls_x.P),
            rls_y=RLSState(theta=th[:, 7:], P=carry.rls_y.P))
        with torch.no_grad():
            _, u, diag = ctlr.solve_batched(carry, states, targets)
        bad = ~(diag.viol <= ctlr.cfg.tol_con) | \
            ~(diag.grad_norm <= RMPC_TOL_GRAD)
        return ctlr, u, diag, bad

    _, u0, _, bad0 = run(False)
    riccati_backward.launches = 0
    t0 = time.perf_counter()
    ctlr1, u1, diag1, bad1 = run(True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ric = riccati_backward.launches
    good = ~bad0
    same = bool(torch.equal(u1[good], u0[good]))
    print(f"[rescue] starved 1x2x1, N={RMPC_N}, B={B}: without the rescue "
          f"{int(bad0.sum())} lanes uncertified; with it "
          f"{int(bad1.sum())} (max viol {float(diag1.viol.max()):.3e}, max "
          f"gnorm {float(diag1.grad_norm.max()):.3e}), {ric} Riccati "
          f"launches, {secs:.3f} s; certified lanes bit-identical: {same}")
    if not bool(bad0.any()):
        raise AssertionError("the starved budget certified every lane")
    if not bool(torch.isfinite(u1).all()):
        raise AssertionError("non-finite rescued controls")
    if not (bool((diag1.viol <= ctlr1.cfg.tol_con + 1e-6).all())
            and bool((diag1.grad_norm <= RMPC_TOL_GRAD).all())):
        raise AssertionError("the rescue left lanes uncertified")
    if ric == 0 or not same:
        raise AssertionError("no Riccati launch, or certified lanes moved")
    return ric


def print_geometry(name: str, launch_geometry, size: int,
                   size_name: str = "N") -> None:
    for dtype in (torch.float32, torch.float64):
        geo = launch_geometry(size, dtype)
        print(f"[times] {name} launch geometry {size_name}={size} "
              f"{str(dtype).replace('torch.', '')}: {geo['threads']} threads "
              f"and {geo['lanes']} lanes per block, {geo['shared_bytes']} "
              f"dynamic shared bytes per block, {geo['blocks_per_sm']} blocks "
              f"per SM resident, {-(-B // geo['lanes'])} blocks at B={B}")


def phase_kernel_times(dev: torch.device, card: str) -> dict:
    from dart_tpu_torch.ops.kernels import riccati as kric
    from dart_tpu_torch.ops.kernels import rmpc_solve as krs

    out = {}
    args = rmpc_problem(3, torch.float32, dev)
    krs.rmpc_solve(*args, **RMPC_KW)
    torch.cuda.synchronize()
    ms = median_ms(lambda: krs.rmpc_solve(*args, **RMPC_KW), 20)
    stats = {}
    t0 = time.perf_counter()
    krs.rmpc_solve_reference(*args, **RMPC_KW, stats=stats)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    plain_ms = median_ms(lambda: krs.rmpc_solve_reference(*args, **RMPC_KW),
                         2)
    dev_ms = device_ms(lambda: krs.rmpc_solve(*args, **RMPC_KW), 10,
                       "rmpc_solve")
    trials = int(stats["trials"].sum())
    flops, trans, nbytes = krs.work(RMPC_N, 6, 3, B, trials, 4)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[times] rmpc_solve B={B} N={RMPC_N} 6x4x3 float32, median per "
          f"call: kernel {ms:.4f} ms ({B / ms * 1e3:.4g} solves/s), plain "
          f"{plain_ms:.2f} ms (first call {first * 1e3:.2f} ms); device per "
          f"launch (profiler) {dev_ms:.4f} ms [{card}]")
    print(f"[times] rmpc_solve work: {flops} FLOPs, {trans} tanh/sin/cos "
          f"({trials} line-search trials, {trials / B:.2f} per lane), "
          f"{nbytes} bytes; bound {bound_ms:.6f} ms by {bound_by}")
    print_geometry("rmpc_solve", krs.launch_geometry, RMPC_N)
    out["rmpc_solve"] = {"ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by}

    args, lo, hi, reg = riccati_problem(620, 20, 6, torch.float32, dev)
    kric.riccati_backward(*args, lo, hi, reg)
    torch.cuda.synchronize()
    ms = median_ms(lambda: kric.riccati_backward(*args, lo, hi, reg), 50)
    plain_ms = median_ms(
        lambda: kric.riccati_backward_reference(*args, lo, hi, reg), 3)
    dev_ms = device_ms(lambda: kric.riccati_backward(*args, lo, hi, reg), 20,
                       "riccati")
    flops, nbytes = kric.work(20, 6, B, 4)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[times] riccati_backward B={B} N=20 nz=6 float32, median per "
          f"call: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms; device per "
          f"launch (profiler) {dev_ms:.4f} ms [{card}]")
    print(f"[times] riccati_backward work: {flops} FLOPs, {nbytes} bytes; "
          f"bound {bound_ms:.6f} ms by {bound_by}")
    for nz in kric.NZ_INSTANCES:
        print_geometry("riccati", kric.launch_geometry, nz, "nz")
    out["riccati_backward"] = {"ms": ms, "plain_ms": plain_ms,
                               "bound_ms": bound_ms, "bound_by": bound_by}

    from dart_tpu_torch.ops.kernels import lmpc_solve as kls
    args = lmpc_problem(11, LMPC_N, torch.float32, dev)
    kls.lmpc_solve(*args, **LMPC_KW)
    torch.cuda.synchronize()
    ms = median_ms(lambda: kls.lmpc_solve(*args, **LMPC_KW), 20)
    plain_ms = median_ms(lambda: kls.lmpc_solve_reference(*args, **LMPC_KW),
                         3)
    dev_ms = device_ms(lambda: kls.lmpc_solve(*args, **LMPC_KW), 20,
                       "lmpc_solve")
    stats = {}
    kls.lmpc_solve_reference(*args, **LMPC_KW, stats=stats)
    trials = int(stats["trials"].sum())
    flops, trans, nbytes = kls.work(LMPC_N, LMPC_KW["n_iters"], B, trials, 4)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[times] lmpc_solve B={B} N={LMPC_N} 2x3 float32, median per "
          f"call: kernel {ms:.4f} ms ({B / ms * 1e3:.4g} solves/s), plain "
          f"{plain_ms:.2f} ms; device per launch (profiler) {dev_ms:.4f} ms "
          f"[{card}]")
    print(f"[times] lmpc_solve work: {flops} FLOPs, {trans} exp/tanh/sin/cos "
          f"({trials} line-search trials, {trials / B:.2f} per lane), "
          f"{nbytes} bytes; bound {bound_ms:.6f} ms by {bound_by}")
    print_geometry("lmpc_solve", kls.launch_geometry, LMPC_N)
    out["lmpc_solve"] = {"ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by}
    return out


# ---------------------------------------------------------------------------
# LMPC whole-solve kernel and closed loop
# ---------------------------------------------------------------------------

LMPC_N = 12           # the LMPC CLI's horizon (cli/lmpc.py:50)
LMPC_DT = 0.01        # and its 10 ms control period
LMPC_STEPS = 1024     # its 1024-step episodes (10.24 s simulated)
LMPC_KW = dict(dt=LMPC_DT, u_bound=0.4, n_iters=2, n_alphas=3)
LMPC_TOL_GRAD = 5e-3
LMPC_SEED = 3
# Quality gates of the LMPC closed loop, from JAX's kernel semantics on this
# scenario (tests/test_torch_lmpc_quality.py; its script run covers every
# lane an H100 run left short; PERF.md section 6). The kernel's semantics
# (2x3 per round, alphas 1, 0.6, 0.36, no regularisation, a lane that
# accepts no trial is done) leave lanes short of 1 cm after 1024 steps,
# nearly all at friction mu = 0.2. Lanes never leave rest where the first
# solve from rest returns V = 0 exactly: u = 0, the plant stays at rest and
# the next step repeats the solve. With the first, one-thread-per-lane
# kernel the card left 174 lanes short (107 at rest, 67 stalled); JAX's
# semantics leave 170 of them short, 106 at rest, and end 4 of the 174
# otherwise: float32 exp and tanh round differently in each library and
# tip line-search ties their own way. The gates allow twice that, 8 lanes.
# The kernel split along the axes leaves 171 short (105 at rest); it and
# JAX end 8 lanes otherwise, 4 each way. The lanes at rest must also be
# exactly the first solve's V = 0 lanes.
LMPC_JAX_SHORT, LMPC_JAX_REST, LMPC_FLIPS = 170, 106, 8
LMPC_SUCCESS_ALL = 1 - (LMPC_JAX_SHORT + LMPC_FLIPS) / B
LMPC_SUCCESS_MOVED = 1 - (LMPC_JAX_SHORT - LMPC_JAX_REST + LMPC_FLIPS) / (
    B - LMPC_JAX_REST)


def lmpc_problem(seed: int, N_: int, dtype: torch.dtype, dev: torch.device):
    """Batch-last inputs of one `lmpc_solve`, as tests/test_lmpc_solve_
    kernel.py makes them (34-vectors U(0.05, 0.5), targets U(-0.08, 0.08)
    on px and py, x0 ~ N(0, 0.02^2)), with a previous tilt U(-0.2, 0.2),
    the default weights, and a warm start U(-0.6, 0.6): partly outside
    +-0.4, which the wrapper clips."""
    from dart_tpu_torch.control import mpc

    rng = np.random.default_rng(seed)
    pv = rng.uniform(0.05, 0.5, (34, B))
    tmask = np.array([1, 0, 1, 0, 0, 0, 0, 0.])[:, None]
    tg = rng.uniform(-0.08, 0.08, (8, B)) * tmask
    z0 = np.concatenate([rng.normal(size=(8, B)) * 0.02,
                         rng.uniform(-0.2, 0.2, (2, B))])
    V0 = rng.uniform(-0.6, 0.6, (N_, 2, B))
    w = mpc.LMPC_DEFAULT_WEIGHTS
    Q = np.repeat(np.asarray(w.Q)[:, None], B, 1)
    R = np.repeat(np.asarray(w.R)[:, None], B, 1)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=dev)

    return [t(pv), t(Q), t(R), t(Q), t(tg), t(z0), t(V0)]


def _lmpc_check(label: str, got, want, tol: dict) -> float:
    """Hold one kernel result to its plain version; returns max |dV|."""
    V, cost, gn = got
    V_p, cost_p, gn_p = want
    for nm, x in (("V", V), ("cost", cost), ("gnorm", gn)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"lmpc kernel {nm} not finite ({label})")
    dV = float((V - V_p).abs().max())
    dV99 = float(torch.quantile((V[0] - V_p[0]).abs().flatten().double(),
                                0.99))
    dc = float(((cost - cost_p).abs() / (1 + cost_p.abs())).max())
    dg = float((gn - gn_p).abs().max())
    print(f"[lmpc] {label}: max|dV| {dV:.3e} (limit {tol['V']:.0e}), "
          f"p99|dV0| {dV99:.3e} (limit {tol['V_p99']:.0e}), "
          f"max|dcost|/(1+|cost|) {dc:.3e} (limit {tol['cost_rel']:.0e}), "
          f"max|dgnorm| {dg:.3e} (limit {tol['gnorm']:.0e}); max gnorm "
          f"{float(gn.max()):.3e}, controls on the bound "
          f"{float((V.abs() >= 0.4).double().mean()):.3f}")
    if (dV > tol["V"] or dV99 > tol["V_p99"] or dc > tol["cost_rel"]
            or dg > tol["gnorm"]):
        raise AssertionError(f"lmpc kernel disagrees with plain ({label})")
    if float(V.abs().max()) > 0.4 + 1e-6:
        raise AssertionError(f"lmpc kernel V outside +-u_bound ({label})")
    return dV


# A budget with more alphas than the 4 threads of one axis run at once, so
# the line search runs them in two chunks and must keep the first-accept
# order. No lane of the usual problem takes an alpha past the fourth, so it
# runs on the problem with every friction's eps scaled by 0.3, where
# stiffer friction rejects more of the first alphas, and in float64 only:
# in float32 the lanes that take a late alpha are those whose result a
# 1-ulp change of z0 moves by ~1e-3 (`lmpc_ulp_witness`, PERF.md).
LMPC_KW_CHUNKED = {**LMPC_KW, "n_alphas": 6}
LMPC_NAN_LANE = 21   # not the first lane of a block of 16 or 4 lanes


def lmpc_stiff_problem(dtype: torch.dtype, dev: torch.device):
    args = lmpc_problem(7, LMPC_N, dtype, dev)
    args[0][[10, 15, 26, 31]] *= 0.3
    return args


def lmpc_ulp_witness(args, kw: dict) -> tuple[float, float]:
    """(max |dV|, max |dcost|/(1+|cost|)) of the plain version's own result
    when z0 moves up by one ulp: no kernel can be held closer to the plain
    version than this on `args`."""
    from dart_tpu_torch.ops.kernels.lmpc_solve import lmpc_solve_reference

    V, cost, _ = lmpc_solve_reference(*args, **kw)
    z0 = args[5]
    up = torch.nextafter(z0, torch.full_like(z0, float("inf")))
    V1, cost1, _ = lmpc_solve_reference(*args[:5], up, args[6], **kw)
    return (float((V1 - V).abs().max()),
            float(((cost1 - cost).abs() / (1 + cost.abs())).max()))


def phase_lmpc(dev: torch.device) -> float:
    """The kernel against its plain version at N = 6, 12 (the main path's
    horizon) and 20, B=4096, 2x3, on ragged batches (B=4000 and B=37, the
    first lanes of the same problem: the plain version is lane by lane, so
    its B=4096 result holds for them), in float64 and float32; with 6
    alphas in chunks on stiffer friction in float64; twice the same call
    bit for bit; a NaN lane among valid ones; a horizon without an
    instance. Returns the float32 max |dV| at N=12."""
    from dart_tpu_torch.ops.kernels.lmpc_solve import (lmpc_solve,
                                                       lmpc_solve_reference)

    err32, clean32 = None, None
    for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, F32_TOL)):
        name = str(dtype).replace("torch.", "")
        for N_ in (6, LMPC_N, 20):
            args = lmpc_problem(N_, N_, dtype, dev)
            got = lmpc_solve(*args, **LMPC_KW)
            want = lmpc_solve_reference(*args, **LMPC_KW)
            dV = _lmpc_check(f"{name} N={N_} B={B}", got, want, tol)
            if N_ != LMPC_N:
                continue
            again = lmpc_solve(*args, **LMPC_KW)
            if not all(bool(torch.equal(x, y)) for x, y in zip(got, again)):
                raise AssertionError(f"lmpc kernel not deterministic ({name})")
            for Bp in (4000, 37):
                sub = [a[..., :Bp].contiguous() for a in args]
                _lmpc_check(f"{name} N={N_} B={Bp}",
                            lmpc_solve(*sub, **LMPC_KW),
                            [w[..., :Bp] for w in want], tol)
            if dtype == torch.float32:
                err32, clean32 = dV, got

    args = lmpc_stiff_problem(torch.float64, dev)
    want6 = lmpc_solve_reference(*args, **LMPC_KW_CHUNKED)
    _lmpc_check(f"float64 N={LMPC_N} B={B} 2x6 stiff",
                lmpc_solve(*args, **LMPC_KW_CHUNKED), want6, F64_TOL)
    # Lanes whose plain result moves when alphas 5 and 6 are offered took
    # one of them: the second chunk decided something there.
    want4 = lmpc_solve_reference(*args, **{**LMPC_KW_CHUNKED, "n_alphas": 4})
    late = int((want6[0] != want4[0]).flatten(0, 1).any(0).sum())
    dV1, dc1 = lmpc_ulp_witness(args, LMPC_KW_CHUNKED)
    print(f"[lmpc] 2x6 stiff: {late} lanes accept an alpha past the first 4 "
          f"in the plain version; a 1-ulp change of z0 moves its max|V| by "
          f"{dV1:.3e} and its cost by {dc1:.3e} relative")
    if late == 0:
        raise AssertionError("no lane reached the second chunk of alphas: "
                             "the 2x6 case tests nothing")
    if dV1 > F64_TOL["V"] or dc1 > F64_TOL["cost_rel"]:
        raise AssertionError("the 2x6 stiff problem is ill-conditioned: the "
                             "plain version cannot hold the kernel to F64_TOL")

    # One lane with a NaN 34-vector, among valid lanes, must report NaN cost
    # and gnorm; every other lane must come out as it did without it.
    args = lmpc_problem(LMPC_N, LMPC_N, torch.float32, dev)
    args[0][:, LMPC_NAN_LANE] = float("nan")
    V, cost, gn = lmpc_solve(*args, **LMPC_KW)
    rest = torch.ones(B, dtype=torch.bool, device=dev)
    rest[LMPC_NAN_LANE] = False
    nan_ok = (bool(torch.isnan(cost[LMPC_NAN_LANE]))
              and bool(torch.isnan(gn[LMPC_NAN_LANE])))
    same = all(bool(torch.equal(x[..., rest], y[..., rest]))
               for x, y in zip((V, cost, gn), clean32))
    print(f"[lmpc] NaN-pvec lane {LMPC_NAN_LANE}: cost "
          f"{float(cost[LMPC_NAN_LANE])}, gnorm {float(gn[LMPC_NAN_LANE])}; "
          f"every other lane as without it: {same}")
    if not (nan_ok and same):
        raise AssertionError("NaN lane not reported, or it leaked")

    # A horizon without a kernel instance is refused before any launch.
    launches = lmpc_solve.launches
    try:
        lmpc_solve(*lmpc_problem(8, 8, torch.float32, dev), **LMPC_KW)
    except NotImplementedError as e:
        print(f"[lmpc] N=8 refused: {e}")
    else:
        raise AssertionError("N=8 launched without a kernel instance")
    if lmpc_solve.launches != launches:
        raise AssertionError("a refused call counted a launch")
    return err32


def lmpc_scenario(dev: torch.device, n: int | None = None):
    """Per-lane plant parameters and targets for n lanes (default B) from
    the trainer's samplers, float32, moved to `dev`. They are drawn from a
    seeded CPU generator, so the CPU tests can draw the same lanes."""
    from dart_tpu_torch.adapt import lmpc_trainer

    gen = torch.Generator().manual_seed(LMPC_SEED)
    pv = lmpc_trainer.sample_true_params(gen, n or B)
    tg = lmpc_trainer.sample_target(gen, n or B)
    return pv.to(dev), tg.to(dev)


def lmpc_controller(**over):
    from dart_tpu_torch.control import mpc
    from dart_tpu_torch.solver import ilqr

    kw = dict(N=LMPC_N, dt=LMPC_DT, u_bound=0.4,
              cfg=ilqr.ILQRConfig(max_iters=4), kernel_iters=2,
              kernel_alphas=3, kernel_tol_grad=LMPC_TOL_GRAD,
              kernel_max_extra_rounds=2)
    kw.update(over)
    return mpc.LMPCBatch(**kw)


def phase_lmpc_main(dev: torch.device, card: str) -> dict:
    from dart_tpu_torch.ops.kernels.lmpc_solve import lmpc_solve
    from dart_tpu_torch.rollout import loop
    from dart_tpu_torch.solver import ilqr

    pv, tg = lmpc_scenario(dev)
    plant = loop.lmpc_plant_step(pv, LMPC_DT)
    ctlr = lmpc_controller()
    x = torch.zeros((B, 8), dtype=torch.float32, device=dev)
    carry = ctlr.init_carry_batch(B, torch.float32, dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    nonfinite, umax = zero.clone(), zero.clone()
    iters, checkpoints = [], {}
    lmpc_solve.launches = 0
    syncs0 = ilqr.host_bool.count
    warm = LMPC_STEPS // 8
    t0 = t_mid = time.perf_counter()
    with torch.no_grad():
        for step in range(LMPC_STEPS):
            if step == warm:
                torch.cuda.synchronize()
                t_mid = time.perf_counter()
            carry, u, diag = ctlr.solve_batched(carry, x, tg, pv)
            if step == 0:
                fixed = (carry.U_plan == 0).all(dim=2).all(dim=1)
            x = plant(x, u)
            nonfinite += (~torch.isfinite(u)).sum()
            umax = torch.maximum(umax, u.abs().amax())
            iters.append(diag.iters[0])
            if step + 1 in (200, 400, 600, 800):
                checkpoints[step + 1] = loop.quality_at_1cm(x, tg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = lmpc_solve.launches
    syncs = ilqr.host_bool.count - syncs0
    step_ms = (t1 - t_mid) / (LMPC_STEPS - warm) * 1e3
    extra = torch.stack(iters).cpu().numpy() // ctlr.kernel_iters - 1
    success, err_mm = loop.quality_at_1cm(x, tg)
    err = torch.hypot(x[:, 0] - tg[:, 0], x[:, 2] - tg[:, 2])
    print(f"[lmpc-main] LMPCBatch {LMPC_STEPS} steps at B={B}, N={LMPC_N}, "
          f"dt={LMPC_DT}, 2x3, float32: {launches} lmpc_solve launches, "
          f"{t1 - t0:.3f} s wall, {step_ms:.4f} ms/step over steps "
          f"{warm}-{LMPC_STEPS} (host clock) [{card}]")
    print(f"[lmpc-main] escalation rounds: total {int(extra.sum())}, steps "
          f"escalated {int((extra > 0).sum())}, steps at the limit "
          f"{int((extra == 2).sum())}; host syncs {syncs}")
    print(f"[lmpc-main] max|u| {float(umax):.6f} (limit 0.4 + 1e-6), "
          f"non-finite controls {int(nonfinite)}")
    print("[lmpc-main] success@1cm by step: " + ", ".join(
        f"{k}: {v[0]:.4f}" for k, v in checkpoints.items())
        + f", {LMPC_STEPS}: {success:.4f}")
    print(f"[lmpc-main] final error: mean {err_mm:.4f} mm, max "
          f"{float(err.max()) * 1e3:.4f} mm")
    at_rest = (x == 0).all(dim=1)
    moved_ok = float(((err < 0.01) & ~at_rest).sum() / (~at_rest).sum())
    print(f"[lmpc-main] lanes short of 1 cm: {int((err >= 0.01).sum())}, of "
          f"which at rest (never moved): {int(at_rest.sum())}; the first "
          f"solve returned V = 0 for {int(fixed.sum())} lanes, the same "
          f"lanes: {bool(torch.equal(fixed, at_rest))}")
    print(f"[lmpc-main] success@1cm over every lane {success:.4f} (gate >= "
          f"{LMPC_SUCCESS_ALL:.4f}), over the {int((~at_rest).sum())} lanes "
          f"that left rest {moved_ok:.4f} (gate >= "
          f"{LMPC_SUCCESS_MOVED:.4f}): JAX's kernel semantics leave "
          f"{LMPC_JAX_SHORT} lanes short, the gates {LMPC_FLIPS} more "
          f"(tests/test_torch_lmpc_quality.py)")
    if int(nonfinite) != 0:
        raise AssertionError("non-finite controls on the LMPC path")
    if float(umax) > 0.4 + 1e-6:
        raise AssertionError("a control left the tilt bound")
    if launches < LMPC_STEPS:
        raise AssertionError(f"only {launches} lmpc_solve launches in "
                             f"{LMPC_STEPS} steps")
    if not torch.equal(fixed, at_rest):
        raise AssertionError("the lanes at rest are not the kernel's fixed "
                             "points from rest")
    if success < LMPC_SUCCESS_ALL or moved_ok < LMPC_SUCCESS_MOVED:
        raise AssertionError(f"LMPC success@1cm {success} (gate "
                             f"{LMPC_SUCCESS_ALL}), over the lanes that "
                             f"left rest {moved_ok} (gate "
                             f"{LMPC_SUCCESS_MOVED})")
    return {"launches": launches, "step_ms": step_ms,
            "err": err.cpu().numpy(), "at_rest": at_rest.cpu().numpy()}


def phase_lmpc_fallback(dev: torch.device, card: str) -> int:
    """`solve_batch` on the LMPC OCP at B=4000, off the kernel's grid, with
    the closed-form and the autodiff linearisation. Returns the Riccati
    launches."""
    from dart_tpu_torch.ops.kernels.riccati import riccati_backward
    from dart_tpu_torch.rollout import loop

    B2, steps = B - 96, 3
    pv, tg = lmpc_scenario(dev, B2)
    plant = loop.lmpc_plant_step(pv, LMPC_DT)
    total = 0
    for fast in (True, False):
        ctlr = lmpc_controller(fast=fast)
        x = torch.zeros((B2, 8), dtype=torch.float32, device=dev)
        carry = ctlr.init_carry_batch(B2, torch.float32, dev)
        riccati_backward.launches = 0
        umax = 0.0
        t0 = time.perf_counter()
        with torch.no_grad():
            for _ in range(steps):
                carry, u, _ = ctlr.solve_batched(carry, x, tg, pv,
                                                 use_kernel=False)
                x = plant(x, u)
                if not bool(torch.isfinite(u).all()):
                    raise AssertionError(f"non-finite controls (fast="
                                         f"{fast})")
                umax = max(umax, float(u.abs().max()))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ric = riccati_backward.launches
        total += ric
        print(f"[lmpc-fallback] fast={fast}: {steps} steps at B={B2}, "
              f"N={LMPC_N}, float32, {ric} Riccati launches (nz=10), "
              f"{secs:.3f} s, max|u| {umax:.6f} [{card}]")
        if ric == 0:
            raise AssertionError("the LMPC solve_batch did not launch the "
                                 "Riccati kernel")
        if umax > 0.4 + 1e-6:
            raise AssertionError("a control left the tilt bound")
    return total


def traced_steps(step, n: int, card: str, label: str) -> None:
    """Trace `n` calls of `step()` with torch.profiler and print the device
    busy time per step, the idle share and the device rows by total."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        cnt, tot = rows.get(e.name, (0, 0.0))
        rows[e.name] = (cnt + 1, tot + us)
    busy = sum(t for _, t in rows.values()) / n / 1e3
    step_ms = wall / n * 1e3
    print(f"[profile] {label}: {n} traced steps, {step_ms:.4f} ms/step "
          f"under the profiler, device busy {busy:.4f} ms/step, idle share "
          f"{1 - busy / step_ms:.4f}, "
          f"{sum(c for c, _ in rows.values()) / n:.1f} device ops/step "
          f"[{card}]")
    ranked = sorted(rows.items(), key=lambda kv: -kv[1][1])
    ours = [kv for kv in ranked[8:] if "_kernel<" in kv[0]
            and kv[0].split("_kernel<")[0].split("::")[-1]
            in ("pmpc_solve", "rmpc_solve", "riccati", "lmpc_solve")]
    for name, (cnt, tot) in ranked[:8] + ours:
        print(f"[profile]   {cnt / n:7.2f}/step {tot / cnt:10.3f} us each "
              f"{tot / n / 1e3:9.4f} ms/step  {name[:90]}")


def phase_profile(dev: torch.device, card: str) -> None:
    """Device time per closed-loop step, from torch.profiler: the RMPC main
    path past its transient, the PMPC fallback (Riccati) path, and the LMPC
    main path."""
    from dart_tpu_torch.control import mpc
    from dart_tpu_torch.rollout import loop

    mus, targets4 = rmpc_scenario(dev)
    plant = loop.pmpc_plant_step(mus, DT)
    ctlr = rmpc_controller()
    solve_fn = loop.rmpc_solve_fn(ctlr, targets4)
    x = torch.zeros((B, 6), dtype=torch.float32, device=dev)
    st = {"c": ctlr.init_carry_batch(x[:, :4]), "x": x}

    def rmpc_step():
        st["c"], st["x"], _ = loop.run_batch_closed_loop(
            solve_fn, plant, st["c"], st["x"], 1)

    for _ in range(600):
        rmpc_step()
    traced_steps(rmpc_step, 20, card, "RMPC closed loop, steps 600-620")

    _, targets, _, weights, params, plant6 = main_path_setup(dev)
    pctlr = mpc.PMPCBatch(N=N, dt=DT, use_kernel=False)
    pfn = loop.pmpc_solve_fn(pctlr, targets, params, weights)
    pst = {"c": pctlr.init_carry(B, torch.float32, dev),
           "x": torch.zeros((B, 6), dtype=torch.float32, device=dev)}

    def pmpc_step():
        pst["c"], pst["x"], _ = loop.run_batch_closed_loop(
            pfn, plant6, pst["c"], pst["x"], 1)

    for _ in range(200):
        pmpc_step()
    traced_steps(pmpc_step, 10, card,
                 "PMPC fallback (use_kernel=False) closed loop, steps 200-210")

    pv, tg = lmpc_scenario(dev)
    lctlr = lmpc_controller()
    lfn = loop.lmpc_solve_fn(lctlr, tg, pv)
    lplant = loop.lmpc_plant_step(pv, LMPC_DT)
    lst = {"c": lctlr.init_carry_batch(B, torch.float32, dev),
           "x": torch.zeros((B, 8), dtype=torch.float32, device=dev)}

    def lmpc_step():
        lst["c"], lst["x"], _ = loop.run_batch_closed_loop(
            lfn, lplant, lst["c"], lst["x"], 1)

    for _ in range(200):
        lmpc_step()
    traced_steps(lmpc_step, 20, card, "LMPC closed loop, steps 200-220")

    from dart_tpu_torch.physics import tray_object as to
    from dart_tpu_torch.rollout import evaluate

    sc = eval_scenarios(dev)
    params = evaluate._tray_params(sc.kappa_inv, sc.mass, sc.mu,
                                   torch.float32)
    u = torch.full((B, 2), 0.05, dtype=torch.float32, device=dev)
    cst = {"s": to.init_state(device=dev, batch=B)}

    def plant_step():
        to.observe_world(cst["s"], params)
        cst["s"] = to.step(cst["s"], u, params, DT)

    for _ in range(50):
        plant_step()
    traced_steps(plant_step, 50, card,
                 "calibrated contact plant (observe + step), steps 50-100")


def phase_scan(dev: torch.device, card: str) -> None:
    """Device ms per launch (torch.profiler), float32, of `riccati_backward`
    against the horizon and the batch and of `pmpc_solve` against its
    budget and the batch: the slope over N is a stage's cost, and a launch
    as long at B=512 as at B=4096 is bound by each warp's chain of
    dependent instructions, not by the card's throughput."""
    from dart_tpu_torch.ops.kernels.pmpc_solve import pmpc_solve
    from dart_tpu_torch.ops.kernels.riccati import riccati_backward

    for nz, N_, Bp in ((6, 10, B), (6, 20, B), (6, 40, B), (6, 20, 512),
                       (10, 20, 4000)):
        args, lo, hi, reg = riccati_problem(N_, N_, nz, torch.float32, dev)
        sub = [a[..., :Bp].contiguous() for a in args]
        reg = reg[:Bp].contiguous()
        riccati_backward(*sub, lo, hi, reg)
        ms = device_ms(lambda: riccati_backward(*sub, lo, hi, reg), 20,
                       "riccati")
        print(f"[scan] riccati_backward nz={nz} N={N_} B={Bp} float32: "
              f"{ms:.4f} ms per launch [{card}]")
    args = kernel_inputs(torch.float32, dev)
    for (it, na), Bp in (((1, 1), B), ((2, 1), B), ((2, 3), B), ((4, 3), B),
                         ((2, 3), 512)):
        sub = [a[..., :Bp].contiguous() for a in args]
        kw = dict(dt=DT, n_iters=it, n_alphas=na)
        pmpc_solve(*sub, **kw)
        ms = device_ms(lambda: pmpc_solve(*sub, **kw), 20, "pmpc_solve")
        print(f"[scan] pmpc_solve N={N} {it}x{na} B={Bp} float32: {ms:.4f} "
              f"ms per launch [{card}]")


# --------------------------------------------------------------------------
# The batch evaluators on the tray-object contact plant, and the sweep CLI
# --------------------------------------------------------------------------

EVAL_STEPS = 2500   # the evaluators' default n_steps (5 s simulated)
EVAL_SOLVES = 450   # (2500 - 250 warm-up steps) / 5 steps per control step
SWEEP_RUNTIME = 10.0
SWEEP_SOLVES = 950  # (5000 - 250) / 5
# JAX's own batch-major RMPC sweep of the same 18 rows at 10 s, on the CPU
# in float32 through `make_rmpc_batch_evaluator(use_kernel=False)`:
#   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_evaluate.py \
#       {calibrated,legacy} 10
# Each sweep run is gated on converging at least as many rows as JAX does.
# On the legacy lag JAX converges 14 of 18: the mu=0.2 cube and cylinder
# rows end 48.5 and 21.3 mm out. The 18/18 of the JAX package's r2
# artifact (artifacts/sweep_rmpc_batch_major_r2.json) predates its r3
# exact (ZOH) lag update.
JAX_SWEEP = {
    "calibrated": {
        "n_converged": 18,
        "sse_mm": [9.997, 9.997, 9.997, 9.966, 9.994, 9.995, 9.945, 9.995,
                   9.998, 9.972, 9.984, 9.999, 9.998, 9.902, 9.988, 9.951,
                   9.907, 9.93],
        "conv_time_s": [2.07, 3.058, 6.018, 2.114, 3.186, 5.664, 1.41, 2.798,
                        5.308, 1.466, 2.624, 5.2, 1.43, 1.4, 1.772, 1.442,
                        1.4, 1.818]},
    "legacy": {
        "n_converged": 14,
        "sse_mm": [9.974, 9.943, 48.474, 9.974, 9.943, 48.474, 9.99, 9.988,
                   21.311, 9.99, 9.988, 21.311, 9.968, 9.949, 9.957, 9.968,
                   9.949, 9.957],
        "conv_time_s": [2.278, 2.814, None, 2.278, 2.814, None, 1.962, 3.188,
                        None, 1.962, 3.188, None, 1.496, 1.252, 1.21, 1.496,
                        1.252, 1.21]},
}
SWEEP_ARTIFACT = (Path(__file__).resolve().parent / "artifacts"
                  / "sweep_rmpc_batch_major_r2.json")


@contextlib.contextmanager
def plant_watch(dev: torch.device):
    """Wrap `tray_object.step`, which the evaluators call through the
    module, to record per lane whether the object ever toppled or left the
    tray, and the largest |u| and the non-finite entries among the applied
    controls. Adds ~10 small device ops to each plant step, so the phases
    gate on a watched run and time another, unwatched one."""
    from dart_tpu_torch.physics import tray_object as to

    step = to.step
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    w = {"toppled": torch.zeros(B, dtype=torch.bool, device=dev),
         "off": torch.zeros(B, dtype=torch.bool, device=dev),
         "umax": zero.clone(), "nonfinite": zero.clone()}

    def watched(s, u, params, dt):
        s2 = step(s, u, params, dt)
        w["toppled"] |= s2.toppled
        w["off"] |= to.off_tray(s2)
        w["umax"] = torch.maximum(w["umax"], u.abs().amax())
        w["nonfinite"] += (~torch.isfinite(u)).sum()
        return s2

    to.step = watched
    try:
        yield w
    finally:
        to.step = step


@contextlib.contextmanager
def count_calls(module, name: str):
    """Count the calls of `module.name` (a module-level function the
    wrappers look up at call time)."""
    fn = getattr(module, name)
    box = [0]

    def counted(*a, **k):
        box[0] += 1
        return fn(*a, **k)

    setattr(module, name, counted)
    try:
        yield box
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def rescue_watch():
    """Count and time (host clock, synchronised) `RMPCBatch._rescue`, the
    per-lane `ilqr.solve_batch` of the lanes the kernel left flagged."""
    from dart_tpu_torch.control import mpc

    orig = mpc.RMPCBatch._rescue
    st = {"calls": 0, "lanes": 0, "s": 0.0}

    def timed(self, bad, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(self, bad, *a)
        torch.cuda.synchronize()
        st["s"] += time.perf_counter() - t0
        st["calls"] += 1
        st["lanes"] += int(bad.sum())
        return out

    mpc.RMPCBatch._rescue = timed
    try:
        yield st
    finally:
        mpc.RMPCBatch._rescue = orig


def eval_scenarios(dev: torch.device):
    """B rows of `random_scenarios(np.random.default_rng(0), B)`: shape,
    mass U(0.5, 3) kg, mu U(0.05, 0.2), target U(-0.1, 0.1)^2 m."""
    from dart_tpu_torch.io import scenes

    return scenes.random_scenarios(np.random.default_rng(0), B, device=dev)


def plant_step_ms(sc, dev: torch.device, n: int = 500) -> float:
    """Host-clock ms of one calibrated contact-plant step alone (`step` at
    B lanes; the evaluators observe only at control steps), synchronised
    over n steps."""
    from dart_tpu_torch.physics import tray_object as to
    from dart_tpu_torch.rollout import evaluate

    params = evaluate._tray_params(sc.kappa_inv, sc.mass, sc.mu,
                                   torch.float32)
    s = to.init_state(device=dev, batch=B)
    u = torch.full((B, 2), 0.05, dtype=torch.float32, device=dev)
    with torch.no_grad():
        for k in range(50 + n):
            if k == 50:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            s = to.step(s, u, params, DT)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def timed_eval(ev, sc):
    """One evaluator call on the scenario rows, synchronised; returns
    (result, host-clock seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ev(sc.kappa_inv, sc.mass, sc.mu, sc.target_xy)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def eval_report(label: str, res, res_w, w: dict, wall: float,
                wall_w: float, plant_ms: float, card: str,
                u_bound: float) -> dict:
    """Print an evaluator's quality and times: `res` and `wall` from the
    unwatched run, `res_w`, `wall_w` and the watch `w` from the watched
    one. Raise on non-finite or out-of-bound controls and non-finite
    results."""
    m = res.metrics
    success = float((m.steady_state_error < 0.01).float().mean())
    conv = float(m.converged.float().mean())
    toppled = float(w["toppled"].float().mean())
    off = float(w["off"].float().mean())
    lost = float((w["toppled"] | w["off"]).float().mean())
    step_ms = wall / EVAL_STEPS * 1e3
    ctrl_ms = (wall - EVAL_STEPS * plant_ms / 1e3) / EVAL_SOLVES * 1e3
    dp = float((res.final_p - res_w.final_p).abs().max())
    print(f"[{label}] {EVAL_STEPS} steps at B={B}, float32, unwatched: "
          f"{wall:.3f} s wall, {step_ms:.4f} ms per plant step of the loop; "
          f"the plant alone {plant_ms:.4f} ms per step, so {ctrl_ms:.4f} ms "
          f"per control step beyond it ({EVAL_SOLVES} control steps; host "
          f"clock) [{card}]; the watched run {wall_w:.3f} s, max |final p| "
          f"difference from it {dp:.3e}")
    print(f"[{label}] success@1cm (final error) {success:.4f}, converged "
          f"(within 1 cm at some step) {conv:.4f}, mean final error "
          f"{float(m.steady_state_error.mean()) * 1e3:.4f} mm; lanes that "
          f"toppled {toppled:.4f}, left the tray {off:.4f}, either "
          f"{lost:.4f}")
    print(f"[{label}] max|u| {float(w['umax']):.6f} (limit {u_bound} + "
          f"1e-6), non-finite controls {int(w['nonfinite'])}")
    if int(w["nonfinite"]) != 0:
        raise AssertionError(f"{label}: non-finite controls")
    if not float(w["umax"]) <= u_bound + 1e-6:
        raise AssertionError(f"{label}: a control left the tilt bound")
    if not (bool(torch.isfinite(res.final_p).all())
            and bool(torch.isfinite(res_w.final_p).all())) or \
            tuple(m.steady_state_error.shape) != (B,):
        raise AssertionError(f"{label}: non-finite or misshapen results")
    return {"wall": wall, "wall_watched": wall_w, "step_ms": step_ms,
            "plant_ms": plant_ms, "ctrl_ms": ctrl_ms, "success": success,
            "lost": lost}


def phase_pmpc_eval(dev: torch.device, card: str) -> dict:
    """`make_pmpc_batch_evaluator()` at its defaults (N=15, u_bound 0.6, 2x3
    kernel budget, a solve every 5 steps after 250 at rest) on the
    calibrated contact plant, 2500 steps at B=4096, float32."""
    from dart_tpu_torch.ops.kernels import pmpc_solve as kps
    from dart_tpu_torch.rollout import evaluate

    sc = eval_scenarios(dev)
    ev = evaluate.make_pmpc_batch_evaluator()
    with count_calls(kps, "pmpc_solve_reference") as plain:
        kps.pmpc_solve.launches = 0
        res, wall = timed_eval(ev, sc)
        launches = kps.pmpc_solve.launches
        with plant_watch(dev) as w:
            res_w, wall_w = timed_eval(ev, sc)
    out = eval_report("pmpc-eval", res, res_w, w, wall, wall_w,
                      plant_step_ms(sc, dev), card, 0.6)
    print(f"[pmpc-eval] pmpc_solve launches {launches} (gate >= "
          f"{EVAL_SOLVES}), plain-version calls {plain[0]} (gate 0)")
    if launches < EVAL_SOLVES:
        raise AssertionError(f"only {launches} pmpc_solve launches")
    if plain[0] != 0:
        raise AssertionError("the plain pmpc_solve ran on the card")
    return {**out, "launches": launches}


@contextlib.contextmanager
def flag_watch():
    """Record, per `RMPCBatch.solve_batched` call, the lanes the kernel
    leaves flagged (viol > tol_con or gnorm > kernel_tol_grad after the
    escalation: the lanes the per-lane rescue takes on when it is on), the
    final gnorm per lane, and the inputs of the call's first `rmpc_solve`
    round (kept on the card, ~2.4 MB a control step at B=4096), for
    `rescue_witness`."""
    from dart_tpu_torch.control import mpc

    orig, kern = mpc.RMPCBatch.solve_batched, mpc.rmpc_solve
    log = {"bad": [], "gnorm": [], "args": []}
    first = []

    def kernel(*a, **k):
        if not first:
            first.append((a, k))
        return kern(*a, **k)

    def watched(self, *a, **k):
        first.clear()
        carry, u, diag = orig(self, *a, **k)
        log["bad"].append(~(diag.viol <= self.cfg.tol_con)
                          | ~(diag.grad_norm <= self.kernel_tol_grad))
        log["gnorm"].append(diag.grad_norm)
        log["args"].append(first[0])
        log["tol"] = (self.cfg.tol_con, self.kernel_tol_grad,
                      self.kernel_max_extra_rounds)
        return carry, u, diag

    mpc.RMPCBatch.solve_batched = watched
    mpc.rmpc_solve = kernel
    try:
        yield log
    finally:
        mpc.RMPCBatch.solve_batched = orig
        mpc.rmpc_solve = kern


WITNESS_STEPS = 12  # flagged control steps sampled, spread over the run
WITNESS_LANES = 16  # flagged lanes per sampled step, and as many unflagged


def rescue_witness(log: dict) -> dict:
    """Whether the lanes the kernel leaves flagged on the contact plant are
    the algorithm's or the kernel's: at WITNESS_STEPS flagged control steps
    of the rescue-off run, take up to WITNESS_LANES flagged lanes and as
    many unflagged ones, and run `rmpc_solve_reference` (the plain version)
    from the kernel's own first-round inputs through the same escalation
    (`mpc._escalate`, the same test, the same extra rounds), in float32
    and float64, on the host's CPU (~4-5 s a round at a few hundred lanes;
    ~11 s a call on the card at any lane count). Counts the lanes it
    leaves flagged among each group."""
    from dart_tpu_torch.control import mpc
    from dart_tpu_torch.ops.kernels.rmpc_solve import rmpc_solve_reference

    bad = torch.stack(log["bad"]).cpu()
    gnorm = torch.stack(log["gnorm"]).cpu()
    hit = torch.nonzero(bad.any(1)).squeeze(1)
    at = torch.linspace(0, len(hit) - 1, min(WITNESS_STEPS, len(hit)))
    steps = hit[at.round().long()].unique().tolist()
    rng = np.random.default_rng(0)
    cols, kflag, kgn = [], [], []
    for s in steps:
        fl = torch.nonzero(bad[s]).squeeze(1).numpy()
        ok = torch.nonzero(~bad[s]).squeeze(1).numpy()
        f = rng.choice(fl, min(WITNESS_LANES, len(fl)), replace=False)
        lanes = np.concatenate([f, rng.choice(ok, len(f), replace=False)])
        a, kw = log["args"][s]
        idx = torch.as_tensor(lanes, device=a[0].device)
        cols.append([x.index_select(-1, idx).cpu() for x in a])
        kflag.append(np.arange(len(lanes)) < len(f))
        kgn.append(gnorm[s, lanes].numpy())
    ins = [torch.cat(c, -1) for c in zip(*cols)]
    kflag, kgn = np.concatenate(kflag), np.concatenate(kgn)
    tol_con, tol_grad, extra = log["tol"]
    nf = int(kflag.sum())
    print(f"[rmpc-eval] witness: {len(steps)} flagged control steps "
          f"{steps}; {nf} lanes the kernel left flagged (median gnorm "
          f"{float(np.median(kgn[kflag])):.3e}) and {nf} it did not")
    out = {"steps": len(steps), "flagged": nf}
    for dtype in (torch.float32, torch.float64):
        x = [t.to(dtype) for t in ins]

        def one_round(V):
            Vn, cost, viol, gn = rmpc_solve_reference(
                *x[:4], torch.movedim(V, 0, -1).contiguous(), **kw)
            return torch.movedim(Vn, -1, 0), cost, viol, gn

        def needs_help(st):
            return ~(torch.max(st[2]) <= tol_con) | \
                ~(torch.max(st[3]) <= tol_grad)

        t0 = time.perf_counter()
        with torch.no_grad():
            (_, _, viol, gn), rounds = mpc._escalate(
                one_round, one_round(torch.movedim(x[4], -1, 0)),
                needs_help, extra)
        pflag = (~(viol <= tol_con) | ~(gn <= tol_grad)).numpy()
        name = str(dtype).split(".")[-1]
        both = int((pflag & kflag).sum())
        extra_lanes = int((pflag & ~kflag).sum())
        print(f"[rmpc-eval] witness, the plain version in {name} on the "
              f"CPU, {1 + rounds} rounds, {time.perf_counter() - t0:.1f} s:"
              f" leaves {both} of the {nf} kernel-flagged lanes flagged "
              f"(median gnorm {float(gn[kflag].median()):.3e}) and "
              f"{extra_lanes} of the {nf} others")
        out[name] = {"flagged": both, "others": extra_lanes}
    return out


RESCUE_STEPS = 265  # three control steps after the warm-up: two rescues


def phase_rmpc_eval(dev: torch.device, card: str) -> dict:
    """`make_rmpc_batch_evaluator()` (N=20, 6x4x3, <= 2 extra rounds, freeze
    at 1 cm) on the same rows: 2500 steps with the per-lane rescue off
    (`kernel_xla_fallback=False`), timed unwatched, then watched, counting
    the lanes the kernel leaves flagged at each control step and holding a
    sample of them to the plain version (`rescue_witness`), then at its
    defaults (rescue on) for its first RESCUE_STEPS steps, timing the
    rescue. The defaults over all 2500 steps do not fit the time limit: on
    these rows the kernel leaves lanes flagged at most control steps, and
    the port's rescue (the host-looped `ilqr.solve_batch`) takes ~10-25 s
    a call on the card whatever the lane count (PERF.md section 5)."""
    from dart_tpu_torch.ops.kernels.riccati import riccati_backward
    from dart_tpu_torch.ops.kernels.rmpc_solve import rmpc_solve
    from dart_tpu_torch.rollout import evaluate

    sc = eval_scenarios(dev)
    ev = evaluate.make_rmpc_batch_evaluator(kernel_xla_fallback=False)
    rmpc_solve.launches = 0
    res, wall = timed_eval(ev, sc)
    launches = rmpc_solve.launches
    with plant_watch(dev) as w, flag_watch() as flags:
        res_w, wall_w = timed_eval(ev, sc)
    out = eval_report("rmpc-eval", res, res_w, w, wall, wall_w,
                      plant_step_ms(sc, dev), card, 0.4)
    flagged = torch.stack(flags["bad"]).sum(1).cpu().numpy()
    hit = np.nonzero(flagged)[0]
    print(f"[rmpc-eval] rescue off: rmpc_solve launches {launches} (gate >= "
          f"{EVAL_SOLVES}); flagged lanes at {len(hit)} of {len(flagged)} "
          f"control steps, {int(flagged.sum())} lane-solves, the first ten "
          f"{flagged[:10].tolist()}, max {int(flagged.max())}, the last "
          f"flagged at control step {hit[-1:].tolist()}")
    if launches < EVAL_SOLVES:
        raise AssertionError(f"only {launches} rmpc_solve launches")
    witness = rescue_witness(flags)
    del flags

    ev = evaluate.make_rmpc_batch_evaluator(n_steps=RESCUE_STEPS)
    with plant_watch(dev) as w2, rescue_watch() as rs:
        riccati_backward.launches = 0
        rmpc_solve.launches = 0
        t0 = time.perf_counter()
        res2 = ev(sc.kappa_inv, sc.mass, sc.mu, sc.target_xy)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        ric, launches2 = riccati_backward.launches, rmpc_solve.launches
    per_call = rs["s"] / max(rs["calls"], 1)
    print(f"[rmpc-eval] defaults (rescue on), {RESCUE_STEPS} steps, "
          f"watched: {wall2:.3f} s wall, {launches2} rmpc_solve launches; rescues "
          f"{rs['calls']} of {rs['lanes']} lanes in all, {rs['s']:.3f} s "
          f"({per_call:.3f} s a call), {ric} Riccati launches; at that rate "
          f"the {len(hit)} flagged control steps of the full run would add "
          f"{len(hit) * per_call:.0f} s [{card}]")
    if rs["calls"] == 0 or ric == 0:
        raise AssertionError("the default evaluator ran no rescue")
    if int(w2["nonfinite"]) != 0 or not float(w2["umax"]) <= 0.4 + 1e-6 or \
            not bool(torch.isfinite(res2.final_p).all()):
        raise AssertionError("rmpc-eval with the rescue: non-finite or "
                             "out-of-bound controls or results")
    return {**out, "launches": launches, "flagged_steps": len(hit),
            "riccati": ric, "rescue_lanes": rs["lanes"],
            "rescue_s": rs["s"], "witness": witness}


def phase_sweep(dev: torch.device, card: str) -> dict:
    """`python -m dart_tpu_torch.cli.sweep --controller rmpc --batch_major
    --runtime 10` (18 rows padded to 128) through the CLI's `main`, on the
    legacy and on the calibrated lag, each gated on converging as many rows
    as JAX's own evaluator does (JAX_SWEEP)."""
    from dart_tpu_torch.cli import sweep as cli
    from dart_tpu_torch.ops.kernels.rmpc_solve import rmpc_solve

    artifact = json.loads(SWEEP_ARTIFACT.read_text())["scenarios"]
    out = {}
    for lag in ("legacy", "calibrated"):
        buf = io.StringIO()
        rmpc_solve.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--controller", "rmpc", "--batch_major",
                           "--runtime", str(SWEEP_RUNTIME), "--tray_lag",
                           lag])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = rmpc_solve.launches
        rows = json.loads(buf.getvalue())["scenarios"]
        ref = JAX_SWEEP[lag]
        n_conv = sum(r["converged"] for r in rows)
        print(f"[sweep] --tray_lag {lag} --runtime {SWEEP_RUNTIME}: "
              f"{n_conv}/{len(rows)} converged (gate >= JAX's "
              f"{ref['n_converged']}), {launches} rmpc_solve launches, "
              f"{wall:.3f} s wall [{card}]")
        for i, r in enumerate(rows):
            line = (f"[sweep]   {r['object']:8s} m={r['mass']:.0f} "
                    f"mu={r['mu']:.2f}: sse {r['sse_mm']:7.2f} mm, conv "
                    f"{r['conv_time_s']} s; JAX (CPU) {ref['sse_mm'][i]:7.3f}"
                    f" mm, {ref['conv_time_s'][i]} s")
            if lag == "legacy":
                a = artifact[i]
                line += (f"; r2 artifact {a['sse_mm']} mm, "
                         f"{a['conv_time_s']} s")
            print(line)
        if rc != 0:
            raise AssertionError(f"the sweep CLI returned {rc}")
        if len(rows) != 18:
            raise AssertionError(f"{len(rows)} sweep rows, not 18")
        if launches < SWEEP_SOLVES:
            raise AssertionError(f"only {launches} rmpc_solve launches in "
                                 "the sweep")
        if n_conv < ref["n_converged"]:
            raise AssertionError(f"{lag} sweep converged {n_conv} rows, JAX "
                                 f"{ref['n_converged']}")
        out[lag] = {"n_converged": n_conv, "launches": launches,
                    "wall": wall}
    return out


PHASES = ("pmpc", "riccati", "rmpc", "main", "fallback", "rmpc-main",
          "rescue", "lmpc", "lmpc-main", "lmpc-fallback", "pmpc-eval",
          "rmpc-eval", "sweep", "times")
# Run only when named: the device-time breakdown behind PERF.md section 5,
# and the Riccati and PMPC kernels' device time against horizon, budget and
# batch.
EXTRA_PHASES = ("profile", "scan")


def run_phase(ph: str, dev: torch.device, card: str, res: dict) -> None:
    if ph == "pmpc":
        res["pmpc_err"] = phase_kernel_vs_plain(dev)
    elif ph == "riccati":
        res["ric_err"] = phase_riccati(dev)
    elif ph == "rmpc":
        res["rmpc_err"] = phase_rmpc(dev)
    elif ph == "main":
        res["pmpc_launches"] = phase_main_path(dev, card)
    elif ph == "fallback":
        res["fallback"] = phase_fallback(dev, card)
    elif ph == "rmpc-main":
        res["rmpc_main"] = phase_rmpc_main(dev, card)
    elif ph == "rescue":
        res["rescue"] = phase_rescue(dev)
    elif ph == "lmpc":
        res["lmpc_err"] = phase_lmpc(dev)
    elif ph == "lmpc-main":
        res["lmpc_main"] = phase_lmpc_main(dev, card)
    elif ph == "lmpc-fallback":
        res["lmpc_fallback"] = phase_lmpc_fallback(dev, card)
    elif ph == "pmpc-eval":
        res["pmpc_eval"] = phase_pmpc_eval(dev, card)
    elif ph == "rmpc-eval":
        res["rmpc_eval"] = phase_rmpc_eval(dev, card)
    elif ph == "sweep":
        res["sweep"] = phase_sweep(dev, card)
    elif ph == "times":
        res["pmpc_times"] = phase_times(dev, card)
        res["times"] = phase_kernel_times(dev, card)
    elif ph == "profile":
        phase_profile(dev, card)
    elif ph == "scan":
        phase_scan(dev, card)


def main(argv: list[str]) -> int:
    phases = argv or list(PHASES)
    unknown = set(phases) - set(PHASES) - set(EXTRA_PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}; "
                         f"choose from {PHASES + EXTRA_PHASES}")
    card = phase_device()
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    phase_build()
    res, failed = {}, []
    for ph in phases:
        t0 = time.perf_counter()
        try:
            run_phase(ph, dev, card, res)
        except Exception:
            traceback.print_exc()
            failed.append(ph)
        print(f"[phase] {ph}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"[phase] all: {time.perf_counter() - t_start:.1f} s")
    if failed:
        print(f"chip_smoke: phases failed: {failed}")
        return 1
    if argv:
        return 0
    t = res["times"]
    print(card)
    print(json.dumps({"kernels": [
        {"name": "pmpc_solve", "route": "cuda",
         "source": "dart_tpu_torch/csrc/pmpc_solve.cu",
         "replaces": "dart_tpu/ops/pallas/pmpc_solve.py:57",
         "launches": res["pmpc_launches"], "max_abs_err": res["pmpc_err"],
         **res["pmpc_times"], "library_ms": None},
        {"name": "riccati_backward", "route": "cuda",
         "source": "dart_tpu_torch/csrc/riccati.cu",
         "replaces": "dart_tpu/ops/pallas/riccati.py:216",
         "launches": res["fallback"]["launches"],
         "max_abs_err": res["ric_err"], **t["riccati_backward"],
         "library_ms": None},
        {"name": "rmpc_solve", "route": "cuda",
         "source": "dart_tpu_torch/csrc/rmpc_solve.cu",
         "replaces": "dart_tpu/ops/pallas/rmpc_solve.py:57",
         "launches": res["rmpc_main"]["launches"],
         "max_abs_err": res["rmpc_err"], **t["rmpc_solve"],
         "library_ms": None},
        {"name": "lmpc_solve", "route": "cuda",
         "source": "dart_tpu_torch/csrc/lmpc_solve.cu",
         "replaces": "dart_tpu/ops/pallas/lmpc_solve.py:58",
         "launches": res["lmpc_main"]["launches"],
         "max_abs_err": res["lmpc_err"], **t["lmpc_solve"],
         "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
