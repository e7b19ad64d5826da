"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (so the script exits non-zero):
1. device: require CUDA, print versions, the card and its power limit;
2. build: compile `dart_tpu_torch/csrc/*.cu` with nvcc, print the seconds;
3. kernel vs plain: the whole-solve kernel against its plain PyTorch
   version at B=4096, N=15, 2 iterations x 3 alphas, in float64 and
   float32, plus one lane with broken Ad structure that must come back +inf;
4. main path: `PMPCBatch` in closed loop with the analytic RK4 plant for
   1200 steps (2.4 s simulated) at B=4096 in float32, gated on finite
   controls, kernel launches and success within 1 cm; then 3 chained warm
   rounds and the projected-gradient certificate;
5. times (printed, not gated): one `pmpc_solve` call, kernel and plain, and
   one closed-loop step.
The last two lines are the kernels' JSON record and the device JSON.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

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
        if "registers" in line or "spill" in line or "Compiling" in line:
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


def phase_times(dev: torch.device, card: str) -> tuple[float, float]:
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
    print(f"[times] pmpc_solve B={B} N={N} {ITERS}x{ALPHAS} float32, median "
          f"per call: kernel {ms:.4f} ms ({B / ms * 1e3:.4g} solves/s), "
          f"plain {plain_ms:.2f} ms ({B / plain_ms * 1e3:.4g} solves/s) "
          f"[{card}]")

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
    return ms, plain_ms


def main() -> int:
    card = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    err32 = phase_kernel_vs_plain(dev)
    launches = phase_main_path(dev, card)
    ms, plain_ms = phase_times(dev, card)
    print(card)
    print(json.dumps({"kernels": [{
        "name": "pmpc_solve", "route": "cuda",
        "source": "dart_tpu_torch/csrc/pmpc_solve.cu",
        "replaces": "dart_tpu/ops/pallas/pmpc_solve.py:57",
        "launches": launches, "max_abs_err": err32,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
