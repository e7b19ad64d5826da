"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, as the gate runs it
    python3 chip_smoke.py riccati rmpc     # only the named phases

The full run builds the kernels, runs the phases in WORKER_GROUPS' five
processes side by side on the card (host-clock times inside them are
taken under that load), then `times` alone; named phases run one after
another in this process.

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
   --batch_major --runtime 7` (18 rows padded to 128) on the legacy and on
   the calibrated lag, each gated on converging as many rows as JAX's own
   batch evaluator does on the CPU (JAX_SWEEP), rows printed beside JAX's;
16. solve: the port's `ilqr.solve` (`vmap(solve)` of the JAX package on a
   lane axis, every backward pass one `riccati_backward` launch) on the
   PMPC, slew-exact RMPC and LMPC OCPs of the commands at B=18 and B=1,
   held to the same call on CPU tensors (float64 at the evaluators'
   budgets to 1e-9; float32 on one iteration, 99th percentile 1e-4, and
   the PMPC solve at the full budget on its iterations and costs, its
   spread printed), with the Riccati launches and host reads
   per solve, no plain Riccati call on the card, argmin on NaN and ties, a
   NaN lane under the parallel line search, and the kernel's time per call
   at B=1 and B=18;
17. pmpc-cli, rmpc-cli: `python -m dart_tpu_torch.cli pmpc|rmpc` at the
   default scenario and CLI_RUNTIME (four episodes each), gated on
   `converged`, the steady-state error and the control effort of JAX's
   own command on the CPU (JAX_CLI), and for rmpc on its controls
   (`--save`), printing the ms per control step, launches and host reads;
18. sweep-instance: `python -m dart_tpu_torch.cli.sweep --runtime
   SWEEP_INSTANCE_RUNTIME` (the per-scenario PMPC evaluator, 18 lanes),
   gated on JAX's own row count and each row's error and effort
   (JAX_SWEEP_INSTANCE);
19. ppo: the converted `general` tuner (artifacts/lmpc/general/
   best_agent.pt): its forward pass, `ppo_loss` and its gradient, and one
   `ppo_update` with equal permutations on the card against the same calls
   on CPU tensors, float64 (1e-10) and float32 (1e-5, 2-norm relative);
20. lmpc-train: float64 `collect_rollout` at the `lmpc` command's settings
   (8 envs, N=12, dt=0.01, 4 iterations, the 520-wide policy) against the
   same call on CPU tensors with the same CPU-drawn inputs (1e-9), every
   backward pass a Riccati launch; the Riccati kernel's time at that
   shape; `lmpc --train` for 1 update of 8 envs x 8 steps (finite
   losses, moved parameters, checkpoints written and reloaded equal) and
   `lmpc --test` on what it wrote, printing seconds per train step and
   per control step, launches and host reads;
21. lmpc-eval: `make_lmpc_evaluator` in float64 with the converted
   lagplant_r5 tuner on four rows, held to JAX's own run (JAX_LMPC_EVAL)
   within 1e-9; then `lmpc --test --env cube_1x0_0x1` and `sweep
   --controller lmpc` at short runtimes, gated on exit 0 and finite rows;
22. arm: the dual-arm world step's layers (chain FK, mass matrix, bias
   forces and Jdot by autodiff, forward dynamics and step with an EE
   wrench, the ADMM QP, the impedance controller on `_arm_dynamics`
   snapshots) on 4096 random lanes of each xArm7 chain against the same
   calls on CPU tensors, float64 (1e-10 relative) and float32 (within 10x
   the CPU's own float32 distance from float64); one world step at
   B=4096: ms, the card's synchronising calls (torch's sync debug mode),
   device ops;
23. full-stack: `run_full_stack` with the `pmpc --full_stack` command's
   PMPC in float64, card against CPU tensors (two control steps after a
   40-step warm-up, 1e-9), every backward pass a Riccati launch; the
   world step's ms, device ops and synchronising calls at B=1; `python -m dart_tpu_torch.cli pmpc
   --full_stack --runtime 0.52` in float32 and in float64 with
   `--no_tune --log_dir`, gated on JAX's own commands (JAX_FULL_STACK);
24. fullstack-train: two float64 `env_step`s of the full-stack trainer
   (8 envs, N=8, 4 iterations, 5 world steps of 20 ADMM iterations) with
   the converted fullstack_r5 tuner, card against CPU tensors on the same
   CPU-drawn inputs (1e-9); `make_train_step(replay=True)` for 1 update
   of 8 envs x 2 steps: finite losses, moved parameters, seconds and
   Riccati launches a train step;
25. mppi-eval: `make_mppi_evaluator()` at its defaults (K=256 x 2
   iterations, one draw a control step shared by the lanes) on the
   calibrated contact plant for 2500 steps at B=4096 rows of
   `random_scenarios(default_rng(0))`, float32, gated on finite controls
   within |u| <= 0.6 + 1e-6, printing success@1cm, the mean final error,
   the seconds an episode, ms a control step and a solve's device ops and
   idle share; the evaluator in float64 on 8 lanes, card against CPU
   tensors fed the same CPU-drawn perturbations (1e-9); `sweep
   --controller mppi --runtime 0.6`: exit 0 and 18 finite rows;
26. neural: `fit_dynamics` at tests/test_neural.py's size (mse < 5e-3),
   the closed loop through the network at nx=4 (one `riccati_backward`
   launch an iteration, the error falling below 1 cm), one `ilqr.solve`
   at nx=6 (nz=8, the generic backward pass, no Riccati launch) card
   against CPU in float64 (1e-9), and the parallel LQR against the
   sequential one;
27. stream: `pmpc --stream --runtime 0.52` (the native ring, a record a
   step, none dropped, Riccati launches), then `watch --idle_timeout 1`;
28. video: `pmpc --full_stack --video --runtime 0.52` and `preview
   --object apple --seconds 0.5`, gated on the frames written and read
   back, frames not blank and the preview's object moving;
29. multidevice: the multi-device layer on the one card, each step
   held to the same work in this process: (a) `run_sweep_batched(
   make_pmpc_batch_evaluator())` over two gloo rank processes, both on
   cuda:0, at B=4096 rows of `random_scenarios(default_rng(0))`, 2500
   steps, float32: every rank's rows the same and bit for bit the two
   one-rank calls' on the ranks' blocks, the aggregate the masked formula
   over them (1e-6 relative), `pmpc_solve` launched on each rank; (b)
   the `sweep` command through the dispatcher under `torchrun --standalone
   --nproc_per_node=1` (NCCL) at SWEEP_INSTANCE_RUNTIME: one JSON,
   `devices` 1, the 18 rows of the command without torchrun, Riccati
   launches; (c) two data-parallel LMPC train steps (the dryrun's
   controller, one env x 2 steps a rank, float32) on the same two
   ranks: finite, the ranks' parameters equal bit for bit, step 1's
   averaged gradient the sequential emulation's (1e-5), Riccati launches
   on each rank; the ranks and torchrun run side by side with this
   process's reference work, so the phase's times are taken under load;
30. times (printed, not gated): each kernel and its plain version per call
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
import os
import socket
import subprocess
import sys
import tempfile
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


def require_card() -> str:
    """Raise unless CUDA is there; turn TF32 off (each process's own
    setting). Returns the card's name and power limit."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card_line()


def phase_device() -> str:
    card = require_card()
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
    """Mean device time in ms of one launch of the template
    `<kernel>_kernel<...>`, from torch.profiler over `reps` calls of `fn`.
    A trace on the card can come back with no device event at all (PR
    10's `times` read none for `rmpc_solve`); such a trace is retried,
    printing what it held, and after three misses this raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        cuda = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        us = [e.time_range.elapsed_us() for e in cuda
              if f"{kernel}_kernel<" in e.name]
        if us:
            return sum(us) / len(us) / 1e3
        seen = sorted({e.name[:80] for e in cuda})
        print(f"[times] device_ms: no {kernel}_kernel launch in the trace "
              f"of {reps} calls (attempt {attempt + 1}); {len(cuda)} device "
              f"events, names {seen[:6]}")
    raise AssertionError(f"torch.profiler recorded no {kernel}_kernel")


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
    carry = ctlr.init_carry(x[:, :4])
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
        carry = ctlr.init_carry(states)
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
    # The plain version takes ~10 s a call here: one timed call.
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    krs.rmpc_solve_reference(*args, **RMPC_KW, stats=stats)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    dev_ms = device_ms(lambda: krs.rmpc_solve(*args, **RMPC_KW), 10,
                       "rmpc_solve")
    trials = int(stats["trials"].sum())
    flops, trans, nbytes = krs.work(RMPC_N, 6, 3, B, trials, 4)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[times] rmpc_solve B={B} N={RMPC_N} 6x4x3 float32, median per "
          f"call: kernel {ms:.4f} ms ({B / ms * 1e3:.4g} solves/s), plain "
          f"{plain_ms:.2f} ms (one call); device per "
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
    carry = ctlr.init_carry(B, torch.float32, dev)
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
        carry = ctlr.init_carry(B2, torch.float32, dev)
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
    st = {"c": ctlr.init_carry(x[:, :4]), "x": x}

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
    lst = {"c": lctlr.init_carry(B, torch.float32, dev),
           "x": torch.zeros((B, 8), dtype=torch.float32, device=dev)}

    def lmpc_step():
        lst["c"], lst["x"], _ = loop.run_batch_closed_loop(
            lfn, lplant, lst["c"], lst["x"], 1)

    for _ in range(200):
        lmpc_step()
    traced_steps(lmpc_step, 20, card, "LMPC closed loop, steps 200-220")

    from dart_tpu_torch.physics import tray_object as to

    sc = eval_scenarios(dev)
    params = to.scenario_params(sc.kappa_inv, sc.mass, sc.mu,
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
SWEEP_RUNTIME = 7.0
SWEEP_SOLVES = 650  # (3500 - 250) / 5
# JAX's own batch-major RMPC sweep of the same 18 rows at 7 s, on the CPU
# in float32 through `make_rmpc_batch_evaluator(use_kernel=False)`:
#   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_evaluate.py \
#       {calibrated,legacy} 7
# Each sweep run is gated on converging at least as many rows as JAX does.
# On the legacy lag JAX converges 14 of 18: the mu=0.2 cube and cylinder
# rows end 53.9 and 28.5 mm out (48.5 and 21.3 at 10 s). Its slowest row
# converges at 6.018 s (calibrated, the card's at 6.04 s), so 7 s converges
# the rows 10 s does. The 18/18 of the JAX package's r2 artifact
# (artifacts/sweep_rmpc_batch_major_r2.json) predates its r3 exact (ZOH)
# lag update.
JAX_SWEEP = {
    "calibrated": {
        "n_converged": 18,
        "sse_mm": [9.997, 9.997, 9.997, 9.966, 9.994, 9.995, 9.945, 9.995,
                  9.998, 9.972, 9.984, 9.999, 9.998, 9.902, 9.988, 9.951,
                  9.907, 9.93],
        "conv_time_s": [2.07, 3.058, 6.018, 2.114, 3.186, 5.664, 1.41, 2.798,
                       5.308, 1.466, 2.624, 5.2, 1.43, 1.4, 1.772, 1.442, 1.4,
                       1.818]},
    "legacy": {
        "n_converged": 14,
        "sse_mm": [9.974, 9.943, 53.923, 9.974, 9.943, 53.923, 9.99, 9.988,
                  28.537, 9.99, 9.988, 28.537, 9.968, 9.949, 9.957, 9.968,
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

    params = to.scenario_params(sc.kappa_inv, sc.mass, sc.mu,
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
                wall_w: float | None, plant_ms: float, card: str,
                u_bound: float) -> dict:
    """Print an evaluator's quality and times: `res` and `wall` from the
    unwatched run, `res_w`, `wall_w` and the watch `w` from the watched
    one; `wall_w` None when one watched run gave all of them. Raise on
    non-finite or out-of-bound controls and non-finite results."""
    m = res.metrics
    success = float((m.steady_state_error < 0.01).float().mean())
    conv = float(m.converged.float().mean())
    toppled = float(w["toppled"].float().mean())
    off = float(w["off"].float().mean())
    lost = float((w["toppled"] | w["off"]).float().mean())
    step_ms = wall / EVAL_STEPS * 1e3
    ctrl_ms = (wall - EVAL_STEPS * plant_ms / 1e3) / EVAL_SOLVES * 1e3
    dp = float((res.final_p - res_w.final_p).abs().max())
    runs = ("watched (~10 small device ops a plant step added)"
            if wall_w is None else "unwatched")
    tail = "" if wall_w is None else (
        f"; the watched run {wall_w:.3f} s, max |final p| difference from it "
        f"{dp:.3e}")
    print(f"[{label}] {EVAL_STEPS} steps at B={B}, float32, {runs}: "
          f"{wall:.3f} s wall, {step_ms:.4f} ms per plant step of the loop; "
          f"the plant alone {plant_ms:.4f} ms per step, so {ctrl_ms:.4f} ms "
          f"per control step beyond it ({EVAL_SOLVES} control steps; host "
          f"clock) [{card}]{tail}")
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
    --runtime 7` (18 rows padded to 128) through the CLI's `main`, on the
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


# ---------------------------------------------------------------------------
# Single-lane solve (`ilqr.solve` on a lane axis) and the commands on it
# ---------------------------------------------------------------------------

SOLVE_B = 18        # the sweep grid's rows
SOLVE_NAN_LANE = 5
# float64: the card and the CPU run the same iterations at the
# evaluators' budgets; the Riccati kernel and its plain version differ by
# FMA contraction (far inside 1e-10 per backward pass), so V agrees to
# 1e-9 on every lane. float32: a few ulps per operation. Once a lane nears
# its optimum its trials differ from its cost at float32's resolution, and
# near an active tilt, slew or velocity bound the box QP's KKT tests (at
# 1e-9) are below it too, so which trial or active set wins is a coin toss
# either side may call otherwise: on an H100 at 700 W the PMPC lanes
# differed by up to 3.8e-3 between the card and the CPU (99th percentile
# 1.5e-3 at 10 iterations, 7.8e-4 at 3; PERF.md section 6), and the CPU's
# own float32 solve differs from its float64 one as much. So float32 is held on one
# iteration (one AL round), before any lane reaches that floor: the bulk
# at 1e-4 (99th percentile of |dV| over every entry), the lanes past 1e-3
# printed. The PMPC solve at the full budget is held on what the tie
# leaves alone: the same iterations on every lane and each lane's cost
# (the trials tie there; 1.9e-7 relative apart on an H100 at 700 W) to
# 1e-5 relative; its |dV| and the CPU's float32-vs-float64 spread are
# printed.
SOLVE_F64_TOL = 1e-9
SOLVE_F32_P99 = 1e-4
SOLVE_F32_COST_RTOL = 1e-5
SOLVE_F32_ITERS = 1
# The single-lane path is host-bound: a control step took ~2 s (PMPC) and
# ~12 s (RMPC, 30 iterations) on an H100 at 700 W (PERF.md section 5), so
# each command runs one or two control steps after its 250 steps of rest,
# four episodes each (a warm call and 3 timed ones), and the sweep two. JAX's
# own commands on the CPU at these runtimes, float32 (script mode of
# tests/test_torch_scenario_eval.py):
#   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_scenario_eval.py
# In so short an episode nothing converges, and the RMPC command's object
# has not moved yet (its steady-state error is the starting offset): the
# gates that see the controller are the PMPC command's steady-state error
# (its object moved 1.04e-5 m) and control effort, the RMPC command's
# controls (`--save`; its slew bound, with the sign the solve chose) and
# effort, and each sweep row's error and effort.
CLI_RUNTIME = {"pmpc": 0.52, "rmpc": 0.51}
SWEEP_INSTANCE_RUNTIME = 0.52
JAX_CLI = {
    "pmpc": {"converged": False, "convergence_time": None,
             "steady_state_error": 0.06402076035737991,
             "control_effort": 0.00870361365377903},
    "rmpc": {"converged": False, "convergence_time": None,
             "steady_state_error": 0.0640312135219574,
             "control_effort": 0.0007071068393997848,
             "u_cmd": [[-0.05000000074505806, 0.05000000074505806]] * 5},
}
JAX_SWEEP_INSTANCE = {
    "n_converged": 0,
    "sse_mm": [64.01, 64.02, 64.03, 64.01, 64.02, 64.03, 64.02, 64.02, 64.02,
               64.02, 64.02, 64.02, 64.03, 64.03, 64.03, 64.03, 64.03, 64.03],
    "effort": [0.0087, 0.0087, 0.0087, 0.0087, 0.0087, 0.0087, 0.0074, 0.0074,
               0.0074, 0.0075, 0.0075, 0.0074, 0.004, 0.004, 0.004, 0.0041,
               0.0041, 0.004]}
# float32 on the card against JAX's float32 on the CPU, on an H100 at
# 700 W: the errors and the RMPC controls agreed to every digit; the PMPC
# effort differed by 6.4e-4 relative (the port on the CPU: 5.9e-5), the
# second solve's float32 tie (see SOLVE_F32_COST_RTOL).
CLI_SSE_ATOL = 1e-6         # m, a tenth of the PMPC object's motion
CLI_EFFORT_RTOL = 5e-3
CLI_U_ATOL = 1e-6           # rad
# The sweep prints sse_mm to 2 decimals and effort to 4: one unit of each.
SWEEP_SSE_MM_ATOL = 0.01
SWEEP_EFFORT_ATOL = 1e-4


def solve_problems(dtype: torch.dtype, dev: torch.device, n: int,
                   iters: int = 10, rounds: int = 3):
    """The three single-lane OCPs of the commands on n lanes (the first n
    of SOLVE_B), as (kind, ocp, cfg, params, aux, z0, V0), from seeded CPU
    draws: PMPC (`make_pmpc_evaluator`'s controller: N=15, 2 ms, u 0.6,
    `iters` iterations, 10 in the evaluator) with the sweep grid's
    friction and per-shape weights per row; slew-exact RMPC
    (`make_rmpc_evaluator`'s: N=20, `iters` iterations x `rounds` AL
    rounds, 10 x 3 in the evaluator) with
    an RLS estimate theta ~ N(0, 0.3); LMPC (N=12, 10 ms, u 0.4, `iters`
    iterations) on `sample_true_params`. States ~ U(-0.1, 0.1) m and
    N(0, 0.05) m/s around rest, cold starts V0 = 0."""
    from dart_tpu_torch.control import mpc
    from dart_tpu_torch.io import scenes
    from dart_tpu_torch.models import dynamics as dyn
    from dart_tpu_torch.physics import tray_object as to
    from dart_tpu_torch.rollout import evaluate
    from dart_tpu_torch.solver import ilqr

    gen = torch.Generator().manual_seed(8)

    def rand(*shape, scale=1.0):
        return ((torch.rand(shape, generator=gen, dtype=torch.float64)
                 * 2 - 1) * scale).to(dtype)

    def normal(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, dtype=torch.float64)
                * scale).to(dtype)

    grid = scenes.sweep_grid(dtype=dtype, device="cpu")
    out = []
    # PMPC
    x = torch.zeros((SOLVE_B, 6), dtype=dtype)
    x[:, 0], x[:, 2] = rand(SOLVE_B, scale=0.1), rand(SOLVE_B, scale=0.1)
    x[:, 1], x[:, 3] = normal(SOLVE_B, scale=0.05), normal(SOLVE_B,
                                                          scale=0.05)
    x[:, 4] = 0.43
    tg = torch.zeros((SOLVE_B, 6), dtype=dtype)
    tg[:, 0], tg[:, 2], tg[:, 4] = 0.05, -0.04, 0.43
    ctl = mpc.PMPC(N=15, dt=DT, u_bound=0.6,
                   cfg=ilqr.ILQRConfig(max_iters=iters))
    w = evaluate._select_weights(to.shape_from_kappa(grid.kappa_inv), dtype)
    aux = mpc._pmpc_aux(x[:n], tg[:n], mpc.PMPCWeights(*(v[:n] for v in w)))
    out.append(("pmpc", ctl.ocp, ctl.cfg,
                dyn.PMPCParams(mu=grid.mu[:n], dt=DT), aux, x[:n],
                torch.zeros((n, 15, 2), dtype=dtype)))
    # RMPC, slew-exact
    ctl = mpc.RMPC(N=20, dt=DT, cfg=ilqr.ILQRConfig(max_iters=iters,
                                                     al_iters=rounds))
    s4 = torch.zeros((SOLVE_B, 4), dtype=dtype)
    s4[:, 0], s4[:, 2] = rand(SOLVE_B, scale=0.1), rand(SOLVE_B, scale=0.1)
    s4[:, 1], s4[:, 3] = normal(SOLVE_B, scale=0.05), normal(SOLVE_B,
                                                            scale=0.05)
    carry = ctl.init_carry(s4[:n], dtype)
    th = normal(SOLVE_B, 14, scale=0.3)[:n]
    carry = carry._replace(rls_x=carry.rls_x._replace(theta=th[:, :7]),
                           rls_y=carry.rls_y._replace(theta=th[:, 7:]))
    t4 = torch.zeros((n, 4), dtype=dtype)
    t4[:, 0], t4[:, 2] = 0.05, -0.04
    params, aux, z0, _ = ctl._front(carry, s4[:n], t4,
                                    mpc.RMPC_DEFAULT_WEIGHTS)
    out.append(("rmpc", ctl.ocp, ctl.cfg, params, aux, z0,
                torch.zeros((n, 20, 2), dtype=dtype)))
    # LMPC
    from dart_tpu_torch.adapt import lmpc_trainer

    pv = lmpc_trainer.sample_true_params(gen, SOLVE_B).to(dtype)[:n]
    z = torch.zeros((SOLVE_B, 8), dtype=dtype)
    z[:, 0], z[:, 2] = rand(SOLVE_B, scale=0.1), rand(SOLVE_B, scale=0.1)
    z[:, 1], z[:, 3] = normal(SOLVE_B, scale=0.05), normal(SOLVE_B,
                                                          scale=0.05)
    tg8 = torch.zeros((n, 8), dtype=dtype)
    tg8[:, 0], tg8[:, 2] = 0.05, -0.04
    ctl = mpc.LMPC(N=LMPC_N, dt=LMPC_DT, u_bound=0.4,
                   cfg=ilqr.ILQRConfig(max_iters=iters))
    aux, z0 = ctl._problem(ctl.init_carry(n, dtype, "cpu"), z[:n], tg8,
                           mpc.LMPC_DEFAULT_WEIGHTS)
    out.append(("lmpc", ctl.ocp, ctl.cfg, pv, aux, z0,
                torch.zeros((n, LMPC_N, 2), dtype=dtype)))
    return [(k, o, c, *(to_dev(x, dev) for x in (p, a, z0_, V0)))
            for k, o, c, p, a, z0_, V0 in out]


def to_dev(tree, dev: torch.device):
    """A tensor or a NamedTuple of tensors and python scalars on `dev`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return type(tree)(*(to_dev(x, dev) if isinstance(x, (torch.Tensor,
                                                          tuple)) else x
                        for x in tree))


@contextlib.contextmanager
def plain_riccati_on_card():
    """Count the calls of `riccati_backward_reference` on CUDA tensors (the
    wrapper must launch the kernel there, never its plain version)."""
    from dart_tpu_torch.ops.kernels import riccati as kric

    fn = kric.riccati_backward_reference
    box = [0]

    def counted(*a, **k):
        box[0] += a[0].device.type == "cuda"
        return fn(*a, **k)

    kric.riccati_backward_reference = counted
    try:
        yield box
    finally:
        kric.riccati_backward_reference = fn


def timed_solve(kind, ocp, cfg, params, aux, z0, V0):
    """One `ilqr.solve`, synchronised; returns (solution, host-clock ms,
    riccati launches, host reads)."""
    from dart_tpu_torch.ops.kernels.riccati import riccati_backward
    from dart_tpu_torch.solver import ilqr

    cuda = z0.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    riccati_backward.launches, ilqr.host_bool.count = 0, 0
    t0 = time.perf_counter()
    sol = ilqr.solve(ocp, cfg, params, aux, z0, V0)
    if cuda:
        torch.cuda.synchronize()
    return (sol, (time.perf_counter() - t0) * 1e3, riccati_backward.launches,
            ilqr.host_bool.count)


def phase_solve(dev: torch.device, card: str) -> dict:
    """The port's `ilqr.solve` on the card for the PMPC, slew-exact RMPC
    (AL) and LMPC OCPs at B=18 and B=1, held to the same call on CPU
    tensors (the Riccati kernel's plain version), float64 and float32;
    every backward pass must be a kernel launch, none the plain version on
    the card; argmin on the card must pick NaN and ties as on the CPU; a
    NaN lane under the parallel line search. Returns per-solve numbers."""
    from dart_tpu_torch.ops.kernels import riccati as kric
    from dart_tpu_torch.solver import ilqr

    # torch.argmin: the first NaN wins, the first of equal values on ties.
    probe = torch.tensor([[1.0, 0.5, 0.5, 2.0], [1.0, float("nan"), 0.2,
                                                 float("nan")],
                          [0.3, 0.3, 0.3, 0.3]], dtype=torch.float64)
    a_cpu = probe.argmin(dim=1).tolist()
    a_card = probe.to(dev).argmin(dim=1).cpu().tolist()
    print(f"[solve] argmin, CPU {a_cpu}, card {a_card} (want [1, 1, 0])")
    if a_card != a_cpu or a_cpu != [1, 1, 0]:
        raise AssertionError("argmin on the card disagrees on NaN or ties")
    out, worst = {}, 0.0
    cpu = torch.device("cpu")
    with plain_riccati_on_card() as plain:
        for dtype, n in ((torch.float64, SOLVE_B), (torch.float64, 1),
                         (torch.float32, SOLVE_B), (torch.float32, 1)):
            f32 = dtype == torch.float32
            iters, rounds = (SOLVE_F32_ITERS, 1) if f32 else (10, 3)
            for pc, pp in zip(solve_problems(dtype, dev, n, iters, rounds),
                              solve_problems(dtype, cpu, n, iters, rounds)):
                kind = pc[0]
                sol, ms, ric, reads = timed_solve(*pc)
                ref = timed_solve(*pp)[0]
                dv = (sol.V.cpu() - ref.V).abs()
                dl = dv.amax(dim=(1, 2))
                it_c, it_p = sol.iters.cpu(), ref.iters
                print(f"[solve] {kind} B={n} {str(dtype)[6:]}, {iters} "
                      f"iterations x {rounds if kind == 'rmpc' else 1} "
                      f"rounds: {ms:.2f} ms a solve (host "
                      f"clock), {ric} Riccati launches, {reads} host reads, "
                      f"iters max {int(it_c.max())} (CPU {int(it_p.max())}),"
                      f" lanes with other iters {int((it_c != it_p).sum())}; "
                      f"max |dV| {float(dv.max()):.3e} [{card}]")
                if ric == 0:
                    raise AssertionError(f"{kind}: no Riccati launch")
                if not bool(torch.isfinite(sol.V).all()):
                    raise AssertionError(f"{kind}: non-finite V")
                if not f32:
                    worst = max(worst, float(dv.max()))
                    if not float(dv.max()) <= SOLVE_F64_TOL:
                        raise AssertionError(f"{kind} B={n}: |dV| "
                                             f"{float(dv.max())} > "
                                             f"{SOLVE_F64_TOL}")
                else:
                    p99 = float(torch.quantile(dv.flatten(), 0.99))
                    off = torch.nonzero(dl > 1e-3).flatten().tolist()
                    print(f"[solve]   float32 p99 |dV| {p99:.3e} (gate "
                          f"{SOLVE_F32_P99:.0e}); lanes past 1e-3: {off}")
                    if not p99 <= SOLVE_F32_P99:
                        raise AssertionError(f"{kind} B={n} float32 p99 "
                                             f"{p99} > {SOLVE_F32_P99}")
                out[(kind, n, str(dtype)[6:])] = {
                    "ms": ms, "riccati": ric, "reads": reads,
                    "iters": int(it_c.max())}
        # float32 at the evaluator's full budget, and the CPU's own float32
        # solve against its float64 one.
        pc = solve_problems(torch.float32, dev, SOLVE_B)[0]
        pp = solve_problems(torch.float32, cpu, SOLVE_B)[0]
        sol, ms, ric, reads = timed_solve(*pc)
        ref = timed_solve(*pp)[0]
        ref64 = timed_solve(*solve_problems(torch.float64, cpu, SOLVE_B)[0])[0]
        dv = (sol.V.cpu() - ref.V).abs()
        d64 = (ref.V.double() - ref64.V).abs()
        dc = ((sol.cost.cpu() - ref.cost).abs() / ref.cost.abs()).max()
        off = torch.nonzero(dv.amax(dim=(1, 2)) > 1e-3).flatten().tolist()
        q99 = lambda x: float(torch.quantile(x.flatten(), 0.99))  # noqa
        print(f"[solve] pmpc B={SOLVE_B} float32, 10 iterations: {ms:.2f} ms "
              f"a solve, {ric} Riccati launches, {reads} host reads; card "
              f"vs CPU max |dV| {float(dv.max()):.3e}, p99 {q99(dv):.3e}, "
              f"lanes past 1e-3 {off}, max relative cost difference "
              f"{float(dc):.3e}; the CPU's float32 vs its float64: max "
              f"{float(d64.max()):.3e}, p99 {q99(d64):.3e}; iters card "
              f"{sol.iters.cpu().tolist()}, CPU {ref.iters.tolist()} "
              f"[{card}]")
        if not (torch.equal(sol.iters.cpu(), ref.iters)
                and float(dc) <= SOLVE_F32_COST_RTOL):
            raise AssertionError(
                f"pmpc float32 at the full budget: relative cost difference"
                f" {float(dc)} (gate {SOLVE_F32_COST_RTOL}) or iterations "
                "differ from the CPU")
        # A NaN lane under the parallel line search, float64.
        pc = solve_problems(torch.float64, dev, SOLVE_B)[0]
        pp = solve_problems(torch.float64, torch.device("cpu"), SOLVE_B)[0]
        par = ilqr.ILQRConfig(max_iters=10, linesearch="parallel")
        for p in (pc, pp):
            p[5][SOLVE_NAN_LANE, 1] = float("nan")
        got = timed_solve(pc[0], pc[1], par, *pc[3:])[0]
        ref = timed_solve(pp[0], pp[1], par, *pp[3:])[0]
        keep = torch.arange(SOLVE_B) != SOLVE_NAN_LANE
        dv = float((got.V.cpu()[keep] - ref.V[keep]).abs().max())
        print(f"[solve] pmpc B={SOLVE_B} parallel search, NaN at lane "
              f"{SOLVE_NAN_LANE}: iters card {got.iters.cpu().tolist()}, CPU "
              f"{ref.iters.tolist()}; other lanes max |dV| {dv:.3e}")
        # No trial beats a NaN cost: the lane keeps its warm start and runs
        # every iteration, its gnorm NaN.
        nan = SOLVE_NAN_LANE
        if not (torch.equal(got.V[nan].cpu(), ref.V[nan])
                and bool(torch.isnan(got.grad_norm[nan]))
                and torch.equal(got.iters.cpu(), ref.iters)
                and dv <= SOLVE_F64_TOL):
            raise AssertionError("the NaN lane under the parallel search "
                                 "differs from the CPU")
    print(f"[solve] plain Riccati calls on the card {plain[0]} (gate 0)")
    if plain[0] != 0:
        raise AssertionError("riccati_backward_reference ran on the card")
    # The Riccati kernel per call at this path's shapes, float32.
    for kind, ocp, cfg, params, aux, z0, V0 in solve_problems(
            torch.float32, dev, SOLVE_B):
        Z = ilqr._rollout(ocp, params, z0, V0)
        n_con = max(ocp.n_con, 1)
        lam = torch.zeros((SOLVE_B, V0.shape[1], n_con), dtype=z0.dtype,
                          device=dev)
        mu = torch.ones((SOLVE_B,), dtype=z0.dtype, device=dev)
        derivs = ilqr._linearize(ocp, params, aux, Z, V0, lam, mu)
        reg = torch.full((SOLVE_B,), 1e-6, dtype=z0.dtype, device=dev)
        for n in (1, SOLVE_B):
            args = [ilqr._batch_last(d[:n]) for d in derivs]
            vb = ilqr._batch_last(V0[:n])
            call = lambda: kric.riccati_backward(   # noqa: E731
                *args, vb, ocp.u_lo, ocp.u_hi, reg[:n])
            call()
            torch.cuda.synchronize()
            ms = median_ms(call, 50)
            nz = z0.shape[1]
            flops, nbytes = kric.work(V0.shape[1], nz, n, 4)
            b_ms, b_by = bound(flops, nbytes)
            print(f"[solve] riccati_backward {kind} N={V0.shape[1]} nz={nz} "
                  f"B={n} float32: {ms:.4f} ms per call (CUDA events, "
                  f"median); bound {b_ms:.6f} ms by {b_by} [{card}]")
            out[("riccati", kind, n)] = ms
    return {"worst_f64": worst, "per": out}


def run_cli_text(argv: list[str]):
    """One command through the dispatcher's `main`, stdout captured;
    returns (rc, its stdout, riccati launches, host reads, wall s)."""
    from dart_tpu_torch.cli.__main__ import main as dispatch
    from dart_tpu_torch.ops.kernels.riccati import riccati_backward
    from dart_tpu_torch.solver import ilqr

    buf = io.StringIO()
    riccati_backward.launches, ilqr.host_bool.count = 0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = dispatch(argv)
    torch.cuda.synchronize()
    return (rc, buf.getvalue().strip(), riccati_backward.launches,
            ilqr.host_bool.count, time.perf_counter() - t0)


def run_cli(argv: list[str]):
    """`run_cli_text` with the JSON on the command's last line (the whole
    output for `sweep`) in place of its stdout."""
    rc, text, ric, reads, wall = run_cli_text(argv)
    return (rc, json.loads(text if argv[0] == "sweep" else
                           text.splitlines()[-1]), ric, reads, wall)


def phase_cli(kind: str, card: str) -> dict:
    """`python -m dart_tpu_torch.cli {pmpc|rmpc} --runtime R` at the
    command's default scenario (cube, 1 kg, mu 0.1, target (0.05, -0.04)),
    float32: four episodes (a warm call, 3 timed), gated on the riccati
    launches, no plain Riccati call on the card, and `converged`, the
    steady-state error, the control effort and (rmpc, through `--save`)
    the controls of JAX's own command on the CPU (JAX_CLI)."""
    R = CLI_RUNTIME[kind]
    n_steps = int(R / DT)
    solves = -(-(n_steps - 250) // 5)
    with plain_riccati_on_card() as plain, \
            tempfile.TemporaryDirectory() as tmp:
        rc, out, ric, reads, wall = run_cli(
            [kind, "--runtime", str(R)]
            + (["--save", tmp] if kind == "rmpc" else []))
        if kind == "rmpc":
            from dart_tpu_torch.io.logging import load_episodes_json

            (ep,) = load_episodes_json(out["log_path"])
            u_cmd = ep["u_cmd"][250:]
    ref = JAX_CLI[kind]
    per_ep = ric / 4
    plant_ms = plant_step_ms_lane1()
    ctrl_ms = (out["run_s"] * 1e3 - n_steps * plant_ms) / solves
    print(f"[{kind}-cli] --runtime {R}: rc {rc}, converged {out['converged']}"
          f" (JAX {ref['converged']}), convergence time "
          f"{out['convergence_time']} s (JAX {ref['convergence_time']}), "
          f"steady-state error {out['steady_state_error']} m (JAX "
          f"{ref['steady_state_error']}), control effort "
          f"{out['control_effort']} (JAX {ref['control_effort']}); first "
          f"call {out['compile_s']} s, "
          f"{out['run_s']} s an episode of {n_steps} steps, {wall:.1f} s "
          f"wall for 4 episodes [{card}]")
    print(f"[{kind}-cli] {ric} riccati launches and {reads} host reads in 4 "
          f"episodes of {solves} control steps: {per_ep / solves:.1f} "
          f"launches and {reads / 4 / solves:.1f} host reads a control "
          f"step; the plant alone {plant_ms:.4f} ms a step at B=1, so "
          f"{ctrl_ms:.1f} ms a control step beyond it [{card}]")
    if rc != 0:
        raise AssertionError(f"{kind} command returned {rc}")
    if ric == 0 or plain[0] != 0:
        raise AssertionError(f"{kind}: {ric} Riccati launches, {plain[0]} "
                             "plain calls on the card")
    if out["converged"] != ref["converged"]:
        raise AssertionError(f"{kind}: converged {out['converged']}, JAX "
                             f"{ref['converged']}")
    d_sse = abs(out["steady_state_error"] - ref["steady_state_error"])
    d_eff = abs(out["control_effort"] / ref["control_effort"] - 1)
    print(f"[{kind}-cli] |steady-state error - JAX's| {d_sse:.3e} m (gate "
          f"{CLI_SSE_ATOL:.0e}), relative control-effort difference "
          f"{d_eff:.3e} (gate {CLI_EFFORT_RTOL:.0e})")
    if not (d_sse <= CLI_SSE_ATOL and d_eff <= CLI_EFFORT_RTOL):
        raise AssertionError(f"{kind}: the episode differs from JAX's")
    if kind == "rmpc":
        d_u = max(abs(a - b) for got, want in zip(u_cmd, ref["u_cmd"])
                  for a, b in zip(got, want))
        print(f"[rmpc-cli] controls from the first solve on {u_cmd} (JAX "
              f"{ref['u_cmd']}), max difference {d_u:.3e} rad (gate "
              f"{CLI_U_ATOL:.0e})")
        if not (len(u_cmd) == len(ref["u_cmd"]) and d_u <= CLI_U_ATOL):
            raise AssertionError("rmpc: the controls differ from JAX's")
    return {"launches": ric, "reads": reads, "run_s": out["run_s"],
            "n_steps": n_steps, "solves": solves, "wall": wall,
            "ctrl_ms": ctrl_ms}


def plant_step_ms_lane1(n: int = 200) -> float:
    """Host-clock ms of one calibrated contact-plant step at B=1 (the
    commands' cube row), synchronised over n steps."""
    from dart_tpu_torch.physics import tray_object as to

    dev = torch.device("cuda", 0)

    def lane(x):
        return torch.tensor([x], dtype=torch.float32, device=dev)

    params = to.scenario_params(lane([0.0, 0.0]), lane(1.0), lane(0.1),
                                torch.float32)
    s = to.init_state(device=dev, batch=1)
    u = torch.full((1, 2), 0.05, dtype=torch.float32, device=dev)
    with torch.no_grad():
        for k in range(20 + n):
            if k == 20:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            s = to.step(s, u, params, DT)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def phase_sweep_instance(card: str) -> dict:
    """`python -m dart_tpu_torch.cli.sweep --runtime R` (defaults: the
    per-scenario PMPC evaluator, the 18 rows as lanes), gated on JAX's own
    per-scenario sweep's row count and each row's error and effort at that
    runtime (JAX_SWEEP_INSTANCE)."""
    R = SWEEP_INSTANCE_RUNTIME
    with plain_riccati_on_card() as plain:
        rc, out, ric, reads, wall = run_cli(["sweep", "--runtime", str(R)])
    rows = out["scenarios"]
    n_conv = sum(r["converged"] for r in rows)
    ref = JAX_SWEEP_INSTANCE
    print(f"[sweep-instance] --controller pmpc --runtime {R}: {n_conv}/"
          f"{len(rows)} converged (gate >= JAX's {ref['n_converged']}), "
          f"{ric} riccati launches, {reads} host reads, {wall:.3f} s wall "
          f"[{card}]")
    for r, sse, eff in zip(rows, ref["sse_mm"], ref["effort"]):
        print(f"[sweep-instance]   {r['object']:8s} m={r['mass']:.0f} "
              f"mu={r['mu']:.2f}: sse {r['sse_mm']:7.2f} mm (JAX {sse:.2f}),"
              f" effort {r['effort']:.4f} (JAX {eff:.4f}), conv "
              f"{r['conv_time_s']} s")
    if rc != 0 or len(rows) != 18:
        raise AssertionError(f"sweep: rc {rc}, {len(rows)} rows")
    off = [i for i, (r, sse, eff) in enumerate(zip(rows, ref["sse_mm"],
                                                   ref["effort"]))
           if not (abs(r["sse_mm"] - sse) <= SWEEP_SSE_MM_ATOL + 1e-9
                   and abs(r["effort"] - eff) <= SWEEP_EFFORT_ATOL + 1e-9)]
    print(f"[sweep-instance] rows off JAX's by more than {SWEEP_SSE_MM_ATOL} "
          f"mm or {SWEEP_EFFORT_ATOL} effort: {off} (gate none)")
    if off:
        raise AssertionError(f"sweep rows {off} differ from JAX's")
    if ric == 0 or plain[0] != 0:
        raise AssertionError(f"sweep: {ric} Riccati launches, {plain[0]} "
                             "plain calls on the card")
    if n_conv < ref["n_converged"]:
        raise AssertionError(f"the per-scenario sweep converged {n_conv} "
                             f"rows, JAX {ref['n_converged']}")
    return {"launches": ric, "reads": reads, "wall": wall,
            "n_converged": n_conv}


# ---------------------------------------------------------------------------
# PPO, the LMPC trainers and the trained-policy LMPC evaluator
# ---------------------------------------------------------------------------

# The trained-policy evaluator on the four rows of
# tests/test_rmpc_batch_eval.py with the lagplant_r5 tuner, float64: 12
# control periods of 5 plant steps, the policy solving at each, its
# controls applied from the sixth (warmup_steps 25), at the evaluator's
# N=12 and four iterations. JAX's own run on the CPU (script mode of
# tests/test_torch_lmpc_eval.py; convergence_time None = inf), each row's
# init_k its draw from jax.random.split(PRNGKey(0), 4):
#   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_lmpc_eval.py
LMPC_EVAL = dict(n_steps=60, control_every=5, warmup_steps=25, N=12,
                 max_iters=4, tol=0.01, trace=True)
JAX_LMPC_EVAL = {
    "init_k": [[0.9702485180099899, 0.32203004128479923, 0.6644854265658197,
                0.9914729435715177, 0.2896963263882896, 0.3619338852146325,
                0.5300045446233874, 0.32938226622175326, 0.06809096367960946,
                0.6189599831680018, 0.9551784249691333, 0.8403787934809114,
                0.7949093470406684, 0.18634696253635277, 0.3793607684220101,
                0.7715128759026629, 0.832242199986808, 0.35806824096345014,
                0.7659297837367471, 0.9276007227398713, 0.05972139138904584,
                0.48749431059407167, 0.28092631084789255, 0.7935859340612128,
                0.3424837692181052, 0.9177886527702978, 0.2838285183122756,
                0.12799933639570726, 0.7121970085651501, 0.7492683839890388,
                0.3863575896322451, 0.37194454579385455, 0.365803623964336,
                0.7663602768509719],
               [0.08981812299767289, 0.9247093472057999, 0.7366128216853052,
                0.5836557418241117, 0.601626975910292, 0.7030263624321398,
                0.8075638963330773, 0.8905753347414238, 0.08551609259931425,
                0.8741294769551397, 0.23437298648886867, 0.6598589779468564,
                0.2993229162457226, 0.6630268780788302, 0.6330714797121424,
                0.46736213770852897, 0.8211579657228749, 0.6547702918038226,
                0.9735716401560498, 0.9450060341339095, 0.9190261211965479,
                0.5588191684738684, 0.7852293901628311, 0.6576857242185324,
                0.765023739853289, 0.988952476539161, 0.6336959721879715,
                0.9171222957433531, 0.7095944014169592, 0.828781957426911,
                0.4201654719806927, 0.30828931239591845, 0.06703244679082648,
                0.7235809500546483],
               [0.6554030330257464, 0.8807497398586577, 0.22106979166586369,
                0.48510802361587096, 0.5082066501243259, 0.2861651244661074,
                0.34599949490556986, 0.8916568068424006, 0.6545292311517963,
                0.10040766727727156, 0.19820391088680872, 0.5772224463963519,
                0.3919482197579697, 0.22517915783040648, 0.1293793103007545,
                0.9404835704644233, 0.7791943041108744, 0.9728399752611083,
                0.8547127511622001, 0.662231949180503, 0.3660075911028396,
                0.5098404121233389, 0.7504113853520831, 0.6296504712643993,
                0.8032653526837792, 0.9133127649457096, 0.8622287322718462,
                0.4510560936547117, 0.2896260400343132, 0.775681681784534,
                0.30518061799632284, 0.5557783678114596, 0.22238257525202695,
                0.6739018062452143],
               [0.7530631940863896, 0.48485026264727626, 0.9781373394574194,
                0.2016656963844141, 0.14551680274044082, 0.2969112561033388,
                0.1883970312043197, 0.8679858371849543, 0.5138627907503361,
                0.37678397104463385, 0.09315695281915451, 0.4450150749391656,
                0.20956623914318845, 0.08171019317587, 0.9891538176369883,
                0.707322046507398, 0.2691511479233387, 0.1639132516512116,
                0.3108661723056288, 0.9780291338806985, 0.4974772016103112,
                0.9580447641198, 0.9971100517820857, 0.9462570654649952,
                0.5000923257532827, 0.3261467655151658, 0.7388524191116069,
                0.8611681471254996, 0.9898350351799993, 0.2993361070289136,
                0.04837395007156725, 0.8764654311493766, 0.6645175020137561,
                0.7700255320682807]],
    "ps": [[[0.0, 0.0],
            [0.0, 0.0],
            [0.0, 0.0],
            [0.0, 0.0],
            [0.0, 0.0],
            [1.9647304013303272e-06, -4.3736925242900826e-07],
            [8.737522910318957e-06, -3.158784169881368e-06],
            [2.0194082682924763e-05, -7.789097895956638e-06],
            [3.6601018313290396e-05, -1.4332752949798382e-05],
            [5.873194041412418e-05, -2.2843140691343464e-05],
            [8.814307093802335e-05, -3.3390044867377965e-05],
            [0.0001276854830150908, -4.60913174804431e-05]],
           [[0.0, 0.0],
            [0.0, 0.0],
            [0.0, 0.0],
            [0.0, 0.0],
            [0.0, 0.0],
            [-2.706834962913151e-06, 6.846999283972728e-08],
            [-1.7676949557653774e-05, 3.1927146820961857e-06],
            [-4.988223054788443e-05, 1.1456875983437106e-05],
            [-0.00010366306425626631, 2.330800316666655e-05],
            [-0.00018407238563534857, 3.869753111641722e-05],
            [-0.000295989557255414, 5.81052070933641e-05],
            [-0.0004439514205242425, 8.234858989130069e-05]],
           [[0.0, 0.0],
            [0.0, 0.0],
            [0.0, 0.0],
            [0.0, 0.0],
            [0.0, 0.0],
            [2.5531753554729985e-06, 1.3489612784697902e-06],
            [1.8469970735531362e-05, 6.522114945289635e-06],
            [5.529608815019996e-05, 5.3667036769319875e-05],
            [0.0001308701347456272, 0.00013720952266997057],
            [0.00022841773245970066, 0.00027770606380108677],
            [0.000365234230149085, 0.00047761005643268893],
            [0.0005307828555529215, 0.0007573985108028656]],
           [[0.0, 0.0],
            [0.0, 0.0],
            [0.0, 0.0],
            [0.0, 0.0],
            [0.0, 0.0],
            [-1.7280514370514652e-06, -4.271857651446894e-07],
            [-7.821748314275828e-06, -4.651976498658608e-06],
            [-1.8079706726266783e-05, -1.3497486017503842e-05],
            [-3.255330306146429e-05, -2.7353545734786812e-05],
            [-5.159722892457434e-05, -4.7288998585248614e-05],
            [-7.59606968504094e-05, -7.575763883879362e-05],
            [-0.00010699864924026093, -0.00011788009295306949]]],
    "us": [[[0.0, 0.0],
            [0.0, 0.0],
            [0.0, 0.0],
            [0.0, 0.0],
            [0.0, 0.0],
            [-0.4, 0.4],
            [-0.4, 0.1777840543327267],
            [-0.4, 0.17665676220571824],
            [-0.4, 0.184732965939158],
            [-0.4, 0.18801644303470655],
            [-0.4, 0.19196682782001326],
            [-0.4, 0.1956539474538519]],
           [[0.0, 0.0],
            [0.0, 0.0],
            [0.0, 0.0],
            [0.0, 0.0],
            [0.0, 0.0],
            [0.4, -0.28642959551502195],
            [0.2318261485929859, -0.2853626605673505],
            [0.22527392329604, -0.15594549897033264],
            [0.2529330614338805, -0.1445467459240127],
            [0.2594959254338055, -0.14636490889914575],
            [0.2682512272913568, -0.14816164418321726],
            [0.275246903874167, -0.1497930042777841]],
           [[0.0, 0.0],
            [0.0, 0.0],
            [0.0, 0.0],
            [0.0, 0.0],
            [0.0, 0.0],
            [-0.4, -0.4],
            [-0.18189861969208254, -0.3985215563701534],
            [-0.1896581624271932, -0.4],
            [-0.20429092460140436, -0.3908985769055677],
            [-0.20424648850788013, -0.3914245562494901],
            [-0.2147620644888815, -0.38573736832226346],
            [-0.21321960928671738, -0.380967394473563]],
           [[0.0, 0.0],
            [0.0, 0.0],
            [0.0, 0.0],
            [0.0, 0.0],
            [0.0, 0.0],
            [0.4, 0.4],
            [0.4, 0.37379500879085314],
            [0.4, 0.37360316036952773],
            [0.4, 0.3636398553942635],
            [0.4, 0.366814380415974],
            [0.4, 0.3710279207954732],
            [0.4, 0.3747899422346466]]],
    "final_p": [[0.0001276854830150908, -4.60913174804431e-05],
                [-0.0004439514205242425, 8.234858989130069e-05],
                [0.0005307828555529215, 0.0007573985108028656],
                [-0.00010699864924026093, -0.00011788009295306949]],
    "contact_lost": [False, False, False, False],
    "steady_state_error": [0.05817632164929117, 0.044287626002264456,
                           0.05738700689642608, 0.07055166525467646],
    "convergence_time": [None, None, None, None],
    "control_effort": [0.03212236093136226, 0.023426890103118977,
                       0.032070826747902216, 0.03837540026584884],
    "min_error": [0.05817632164929117, 0.044287626002264456,
                  0.05738700689642608, 0.07055166525467646],
    "converged": [False, False, False, False],
}


# The trainer's float32 control step took 3.7 s on an H100 at 700 W (4
# iterations whose backtracking runs all 11 trials; PERF.md section 6), so
# the commands run short: 1 update of 8 envs x 8 steps, 4 test steps, and
# 3 control periods of the contact-plant commands.
LMPC_TRAIN_B = 8           # the lmpc command's --envs
LMPC_TRAIN_STEPS = 4       # collect_rollout steps held to the CPU
LMPC_TRAIN_CLI = ["--updates", "1", "--envs", "8", "--rollout_len", "8"]
LMPC_TEST_STEPS = 4        # lmpc --test --eval_episode_steps
LMPC_ENV_STEPS = 3         # lmpc --test --env: control periods
LMPC_SWEEP_RUNTIME = 0.03  # sweep --controller lmpc: 3 control periods
LMPC_SWEEP_PERIODS = 3
# float64: the card and the CPU run the same operations in another order
# (reductions, the Riccati kernel's FMAs); the policy's forward pass and
# one PPO update agree far inside 1e-10 (largest difference), the LMPC
# rollout through its stiff friction inside 1e-9. float32: the forward
# outputs, the gradients and the parameters after the update by each
# group's 2-norm relative difference, its largest elementwise one printed
# beside it: Adam moves an entry whose gradient is at float32's round-off
# by +-lr a step whichever sign the round-off takes, so a largest
# difference against a largest entry reached 5.5e-5 on the parameters
# after 32 steps on an H100 at 700 W. The loss, its parts and the update's
# stats term by term, each over the larger of its own size and the value
# loss's: the policy loss is a mean of terms that cancel (1.2e-5 of its
# own size apart), and a 2-norm over the group would read only the
# entropy term, which depends on log_std alone.
PPO_F64_TOL = 1e-10
PPO_F32_RTOL = 1e-5
LMPC_TRAIN_TOL = 1e-9
LMPC_EVAL_TOL = 1e-9
# `lmpc --test --env` runs only in float32: its solves, card vs CPU, as
# the float32 policy forward pass (PPO_F32_RTOL) and, for the controls,
# a tenth of a milliradian of the 0.4 rad bound.
LMPC_ENV_K_RTOL = 1e-5
LMPC_ENV_U_TOL = 1e-4
TUNERS = Path(__file__).resolve().parent / "artifacts" / "lmpc"


def _max_diff(got, want, rel: bool) -> float:
    """Largest |got - want| over a tensor, or over its largest |want| with
    `rel`."""
    d = float((got.detach().cpu().double() - want.detach().double())
              .abs().max())
    return d / max(float(want.detach().abs().max()), 1e-30) if rel else d


def _norm_rel(got: list, want: list) -> float:
    """||got - want||_2 / ||want||_2 over a group of tensors."""
    g = torch.cat([x.detach().cpu().double().reshape(-1) for x in got])
    w = torch.cat([x.detach().double().reshape(-1) for x in want])
    return float(torch.linalg.vector_norm(g - w)
                 / max(float(torch.linalg.vector_norm(w)), 1e-30))


def _terms_rel(got, want, scale: int) -> list[float]:
    """Each scalar term's |got - want| over the larger of its own |want|
    and term `scale`'s."""
    got, want = ([float(x.detach()) for x in v] for v in (got, want))
    return [abs(g - w) / max(abs(w), abs(want[scale]), 1e-30)
            for g, w in zip(got, want)]


def _ppo_case(dtype: torch.dtype, dev: torch.device):
    """The converted `general` tuner on `dev` in `dtype` (float64: every
    parameter cast, as JAX's sweep casts them) with its Adam state, and a
    batch of 512 observations near the tuner's own (seeded numpy)."""
    from dart_tpu_torch.adapt import lmpc_trainer as trainer
    from dart_tpu_torch.adapt import ppo as ppo_mod
    from dart_tpu_torch.io import checkpoint as ckpt

    saved = ckpt.load_agent(str(TUNERS / "general"))
    model = ppo_mod.ActorCritic(trainer.N_PARAMS, trainer.OBS_DIM)
    model.load_state_dict(saved["model"])
    if dtype == torch.float64:
        model = model.to(torch.float64)
    rng = np.random.default_rng(11)
    T = 512
    obs = torch.from_numpy(rng.normal(size=(T, trainer.OBS_DIM))).to(dtype)
    with torch.no_grad():
        mean, std, _ = model(obs)
    acts = mean + std * torch.from_numpy(
        rng.normal(size=(T, trainer.N_PARAMS))).to(dtype)
    logps = ppo_mod.normal_logp(acts, mean, std) \
        + torch.from_numpy(rng.normal(size=T) * 0.05).to(dtype)
    batch = ppo_mod.Batch(obs, acts, logps,
                          *(torch.from_numpy(rng.normal(size=T)).to(dtype)
                            for _ in range(2)))
    model = model.to(dev)
    opt = ppo_mod.make_optimizer(model, ppo_mod.PPOConfig())
    opt.load_state_dict(saved["optimizer"])
    return model, opt, ppo_mod.Batch(*(x.to(dev) for x in batch))


def phase_ppo(dev: torch.device, card: str) -> dict:
    """The converted `general` tuner's forward pass, `ppo_loss` and its
    gradient, and one `ppo_update` (equal permutations) on the card
    against the same calls on CPU tensors, float64 (1e-10, the largest
    difference) and float32 (1e-5: the forward outputs, gradients and
    parameters by each group's 2-norm relative difference, the loss terms
    and the update's stats each on its own, see PPO_F32_RTOL)."""
    from dart_tpu_torch.adapt import ppo as ppo_mod

    cfg = ppo_mod.PPOConfig(epochs=4, minibatch_size=64)
    perms = ppo_mod.draw_perms(torch.Generator().manual_seed(12),
                               cfg.epochs, 512)
    out = {}
    for dtype in (torch.float64, torch.float32):
        rel = dtype == torch.float32
        gate = PPO_F32_RTOL if rel else PPO_F64_TOL
        runs = []
        for d in (dev, torch.device("cpu")):
            model, opt, batch = _ppo_case(dtype, d)
            with torch.no_grad():
                fwd = model(batch.obs)
            model.zero_grad()
            loss, aux = ppo_mod.ppo_loss(model, batch, cfg)
            loss.backward()
            grads = [p.grad.clone() for p in model.parameters()]
            if d.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = ppo_mod.ppo_update(model, opt, batch, cfg, perms)
            if d.type == "cuda":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            runs.append((fwd, (loss, *aux), grads,
                         [p.detach() for p in model.parameters()], stats, ms))
        (fc, lc, gc, pc, sc, ms), (fp, lp, gp, pp, sp, _) = runs
        groups = {"forward": (fc, fp), "loss": (lc, lp), "grad": (gc, gp),
                  "params": (pc, pp), "stats": (sc, sp)}
        largest = {k: max(_max_diff(a, b, rel) for a, b in zip(*v))
                   for k, v in groups.items()}
        name = str(dtype)[6:]
        if rel:
            # The value loss is term 2 of (loss, policy, value, entropy)
            # and term 1 of the stats (policy, value, entropy).
            terms = {"loss": _terms_rel(lc, lp, 2),
                     "stats": _terms_rel(sc, sp, 1)}
            worst = {k: _norm_rel(*groups[k])
                     for k in ("forward", "grad", "params")}
            worst.update({k: max(v) for k, v in terms.items()})
            how = ("2-norm relative difference forward, grad, params; "
                   "each term over max(|term|, |value loss|) "
                   + ", ".join(f"{k} [" + ", ".join(f"{x:.3e}" for x in v)
                               + "]" for k, v in terms.items())
                   + "; worst ")
        else:
            worst = largest
            how = "largest difference "
        print(f"[ppo] {name}: card vs CPU, {how}"
              + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
              + f" (gate {gate:.0e})" + (
                  "; largest against the largest entry " + ", ".join(
                      f"{k} {v:.3e}" for k, v in largest.items()) if rel
                  else "")
              + f"; one ppo_update (512 samples, 4 epochs x 8 minibatches) "
              f"{ms:.1f} ms on the card [{card}]")
        if not max(worst.values()) <= gate:
            raise AssertionError(f"ppo {name}: the card differs from the "
                                 f"CPU: {worst}")
        out[name] = {"worst": worst, "update_ms": ms}
    return out


def _lmpc_train_setup(dev: torch.device, gen: torch.Generator):
    """The lmpc command's trainer at its settings (B=8, N=12, dt=0.01,
    four iterations, the 520-wide policy from seed 0) in float64 on
    `dev`, its start and LMPC_TRAIN_STEPS steps of draws from `gen` (a
    CPU generator)."""
    from dart_tpu_torch.adapt import lmpc_trainer as trainer
    from dart_tpu_torch.adapt import ppo as ppo_mod
    from dart_tpu_torch.control import mpc as mpc_mod

    f64 = torch.float64
    ctlr = mpc_mod.LMPC(N=LMPC_N, dt=LMPC_DT,
                        cfg=mpc_mod.ilqr.ILQRConfig(max_iters=4))
    cfg = trainer.EnvConfig(dt=LMPC_DT, max_episode_steps=1024)
    ts = trainer.init_train_state(torch.Generator().manual_seed(0),
                                  ppo_mod.PPOConfig(epochs=4,
                                                    minibatch_size=64), dev)
    init = trainer.draw_init(gen, LMPC_TRAIN_B, cfg, f64, dev)
    draws = [trainer.draw_step(gen, LMPC_TRAIN_B, f64, dev)
             for _ in range(LMPC_TRAIN_STEPS)]
    s0 = trainer.env_init(ctlr, cfg, LMPC_TRAIN_B, f64, dev, draws=init)
    return ts.model, ctlr, cfg, s0, draws


def _leaves(tree, prefix=""):
    for name, x in zip(tree._fields, tree):
        if isinstance(x, tuple):
            yield from _leaves(x, f"{prefix}{name}.")
        elif isinstance(x, torch.Tensor):
            yield prefix + name, x


def riccati_at(ocp, params, aux, z0, V0, card: str, label: str) -> dict:
    """`riccati_backward` per call (CUDA events, median of 50) at this
    OCP's linearisation about V0, and its bound from `work()`."""
    from dart_tpu_torch.ops.kernels import riccati as kric
    from dart_tpu_torch.solver import ilqr

    B, N_, _ = V0.shape
    Z = ilqr._rollout(ocp, params, z0, V0)
    n_con = max(ocp.n_con, 1)
    lam = torch.zeros((B, N_, n_con), dtype=z0.dtype, device=z0.device)
    mu = torch.ones((B,), dtype=z0.dtype, device=z0.device)
    derivs = ilqr._linearize(ocp, params, aux, Z, V0, lam, mu)
    reg = torch.full((B,), 1e-6, dtype=z0.dtype, device=z0.device)
    args = [ilqr._batch_last(d) for d in derivs]
    vb = ilqr._batch_last(V0)

    def call():
        kric.riccati_backward(*args, vb, ocp.u_lo, ocp.u_hi, reg)

    call()
    torch.cuda.synchronize()
    ms = median_ms(call, 50)
    nz = z0.shape[1]
    b_ms, b_by = bound(*kric.work(N_, nz, B, z0.element_size()))
    print(f"[{label}] riccati_backward N={N_} nz={nz} B={B} "
          f"{str(z0.dtype)[6:]}: {ms:.4f} ms per call (CUDA events, "
          f"median); bound {b_ms:.6f} ms by {b_by} [{card}]")
    return {"ms": ms, "bound_ms": b_ms, "bound_by": b_by}


def phase_lmpc_train(dev: torch.device, card: str) -> dict:
    """The LMPC trainer on the card: (a) float64 `collect_rollout` at the
    command's settings against the same call on CPU tensors with the same
    CPU-drawn inputs (1e-9 on actions, rewards, values and every state
    leaf), every backward pass a Riccati launch and none the plain
    version; the kernel at this path's shape, float32; (b) `lmpc --train`
    for one update of 8 envs x 8 steps: finite losses, moved
    parameters, best and latest written and reloaded equal; (c) `lmpc
    --test` on what it wrote."""
    from dart_tpu_torch.adapt import lmpc_trainer as trainer
    from dart_tpu_torch.adapt import ppo as ppo_mod
    from dart_tpu_torch.control import mpc as mpc_mod
    from dart_tpu_torch.io import checkpoint as ckpt
    from dart_tpu_torch.ops.kernels.riccati import riccati_backward
    from dart_tpu_torch.solver import ilqr
    from dart_tpu_torch.utils.tree import tree_to

    out = {}
    with plain_riccati_on_card() as plain:
        runs = []
        for d in (dev, torch.device("cpu")):
            model, ctlr, cfg, s0, draws = _lmpc_train_setup(
                d, torch.Generator().manual_seed(13))
            if d.type == "cuda":
                torch.cuda.synchronize()
            riccati_backward.launches, ilqr.host_bool.count = 0, 0
            t0 = time.perf_counter()
            res = trainer.collect_rollout(model, ctlr, s0, cfg,
                                          LMPC_TRAIN_STEPS, draws)
            if d.type == "cuda":
                torch.cuda.synchronize()
            runs.append((res, time.perf_counter() - t0,
                         riccati_backward.launches, ilqr.host_bool.count))
        ((sc, trc, lvc), secs, ric, reads), ((sp, trp, lvp), cpu_s, _, _) = \
            runs
        worst = {name: _max_diff(a, b, False) for (name, a), (_, b) in zip(
            [*_leaves(trc, "traj."), *_leaves(sc, "state."),
             ("last_value", lvc)],
            [*_leaves(trp, "traj."), *_leaves(sp, "state."),
             ("last_value", lvp)])}
        top = max(worst, key=worst.get)
        per = secs / LMPC_TRAIN_STEPS
        print(f"[lmpc-train] collect_rollout B={LMPC_TRAIN_B} N={LMPC_N} "
              f"float64, {LMPC_TRAIN_STEPS} steps: card vs CPU largest "
              f"difference {worst[top]:.3e} ({top}; actions "
              f"{worst['traj.action']:.3e}, rewards {worst['traj.reward']:.3e}"
              f", values {worst['traj.value']:.3e}; gate "
              f"{LMPC_TRAIN_TOL:.0e}); {per * 1e3:.1f} ms a control step on "
              f"the card (CPU {cpu_s / LMPC_TRAIN_STEPS * 1e3:.1f}), {ric} "
              f"Riccati launches, {reads} host reads [{card}]")
        if not worst[top] <= LMPC_TRAIN_TOL:
            raise AssertionError(f"lmpc-train: the card's rollout differs "
                                 f"from the CPU's: {top} {worst[top]}")
        if ric == 0:
            raise AssertionError("lmpc-train: no Riccati launch")
        out["collect"] = {"worst": worst[top], "ctrl_s_f64": per,
                          "launches": ric, "reads": reads}
        # The kernel at the trainer's shape, float32, about the state the
        # rollout reached.
        s32 = tree_to(sc, dev, torch.float32)
        aux, z0 = ctlr._problem(s32.ctrl_carry, s32.x, s32.target,
                                mpc_mod.LMPC_DEFAULT_WEIGHTS)
        out["riccati"] = riccati_at(ctlr.ocp, s32.current_k, aux, z0,
                                    s32.ctrl_carry.V, card, "lmpc-train")

        with tempfile.TemporaryDirectory() as tmp:
            rc, text, ric, reads, wall = run_cli_text(
                ["lmpc", "--train", *LMPC_TRAIN_CLI, "--checkpoint_dir",
                 tmp])
            lines = [json.loads(x) for x in text.splitlines()]
            ups, done = lines[:-1], lines[-1]
            step_s = done["timing"]["mean_ms"] / 1e3
            n_upd = int(LMPC_TRAIN_CLI[1])
            T = int(LMPC_TRAIN_CLI[5])
            print(f"[lmpc-train] lmpc --train {' '.join(LMPC_TRAIN_CLI)}: "
                  f"rc {rc}, updates {ups}; {step_s:.2f} s a train step "
                  f"(p50 {done['timing']['p50_ms'] / 1e3:.2f}), "
                  f"{step_s / T * 1e3:.1f} ms a control step with the PPO "
                  f"update spread over it, {ric / n_upd:.0f} Riccati "
                  f"launches and {reads / n_upd:.0f} host reads a train "
                  f"step (at most 4 x {T} launches), {wall:.1f} s wall "
                  f"[{card}]")
            losses = [u[k] for u in ups for k in ("policy_loss",
                                                  "value_loss")]
            if rc != 0 or len(ups) != n_upd or not all(
                    np.isfinite(x) for x in losses + [done["reward_last"]]):
                raise AssertionError(f"lmpc --train: rc {rc}, {lines}")
            if not 0 < ric <= 4 * T * n_upd:
                raise AssertionError(f"lmpc --train: {ric} Riccati launches")
            fresh = trainer.init_train_state(torch.Generator().manual_seed(0),
                                             ppo_mod.PPOConfig(), "cpu").model
            best = ckpt.load_agent(tmp, "best_agent")
            latest = ckpt.load_agent(tmp, "latest_agent")
            moved = sum(float((latest["model"][k] - v).abs().sum())
                        for k, v in fresh.state_dict().items())
            fresh.load_state_dict(latest["model"])
            opt = ppo_mod.make_optimizer(fresh, ppo_mod.PPOConfig())
            opt.load_state_dict(latest["optimizer"])
            again = all(torch.equal(fresh.state_dict()[k], v)
                        for k, v in latest["model"].items())
            steps = {int(s["step"]) for s in
                     opt.state_dict()["state"].values()}
            print(f"[lmpc-train] best_agent.pt episode {best['episode']} "
                  f"return {best['return']:.3f}, latest_agent.pt episode "
                  f"{latest['episode']}; parameters moved by "
                  f"{moved:.3e} in sum; reloaded equal {again}, Adam steps "
                  f"{steps}")
            best_ret = max(u["mean_reward"] for u in ups)   # 3 decimals
            if not (moved > 0 and again and latest["episode"] == n_upd - 1
                    and abs(best["return"] - best_ret) <= 5e-4):
                raise AssertionError("lmpc --train: the parameters did not "
                                     "move, or the checkpoints are wrong")
            out["train"] = {"step_s": step_s, "launches": ric / n_upd,
                            "reads": reads / n_upd, "wall": wall}

            rc, text, ric, reads, wall = run_cli_text(
                ["lmpc", "--test", "--checkpoint_dir", tmp, "--envs", "8",
                 "--eval_episode_steps", str(LMPC_TEST_STEPS)])
            res = json.loads(text.splitlines()[-1])
            print(f"[lmpc-train] lmpc --test (general, 8 envs, "
                  f"{LMPC_TEST_STEPS} control steps): rc {rc}, {res}; "
                  f"{wall / LMPC_TEST_STEPS * 1e3:.1f} ms a control step, "
                  f"{ric} Riccati launches, {reads} host reads [{card}]")
            if rc != 0 or not all(np.isfinite(v) for v in res.values()):
                raise AssertionError(f"lmpc --test: rc {rc}, {res}")
            out["test"] = {"ctrl_s": wall / LMPC_TEST_STEPS, "launches": ric}
    print(f"[lmpc-train] plain Riccati calls on the card {plain[0]} "
          "(gate 0)")
    if plain[0] != 0:
        raise AssertionError("riccati_backward_reference ran on the card")
    return out


@contextlib.contextmanager
def lmpc_solve_watch():
    """Record each `LMPC.solve` call's parameter vectors (B, 34) and
    controls (B, 2), as float64 CPU tensors, while the block runs."""
    from dart_tpu_torch.control import mpc as mpc_mod

    fn = mpc_mod.LMPC.solve
    log = []

    def solve(self, carry, state, target, pvec, *a, **k):
        out = fn(self, carry, state, target, pvec, *a, **k)
        log.append((pvec.detach().cpu().double(),
                    out[1].detach().cpu().double()))
        return out

    mpc_mod.LMPC.solve = solve
    try:
        yield log
    finally:
        mpc_mod.LMPC.solve = fn


def _solves_diff(got: list, want: list) -> tuple[float, float]:
    """(largest |dk| over max(|k|, 1), largest |du|) over two runs' solve
    logs, solve by solve; inf when their lengths differ."""
    if len(got) != len(want):
        return float("inf"), float("inf")
    d_k = max(float(((a - b).abs() / b.abs().clamp_min(1.0)).max())
              for (a, _), (b, _) in zip(got, want))
    d_u = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(got, want))
    return d_k, d_u


def phase_lmpc_eval(dev: torch.device, card: str) -> dict:
    """The trained-policy LMPC evaluator on the card in float64 with the
    converted lagplant_r5 tuner on the four rows, JAX's init_k, held to
    JAX's own run (JAX_LMPC_EVAL: positions and controls at every control
    period, final positions, contact loss, metrics) within 1e-9; then
    `lmpc --test --env cube_1x0_0x1` with that tuner and `sweep
    --controller lmpc` at short runtimes, inside their warm-up: each
    solve's parameter vectors and controls held between the card and the
    same command on `--cpu` (float32 for the first, float64 for the
    sweep), and the policy seen to move the vector."""
    from dart_tpu_torch.adapt import lmpc_trainer as trainer
    from dart_tpu_torch.adapt import ppo as ppo_mod
    from dart_tpu_torch.io import checkpoint as ckpt
    from dart_tpu_torch.ops.kernels.riccati import riccati_backward
    from dart_tpu_torch.rollout import evaluate

    f64 = torch.float64
    model = ppo_mod.ActorCritic(trainer.N_PARAMS, trainer.OBS_DIM)
    model.load_state_dict(ckpt.load_agent(str(TUNERS / "lagplant_r5"))[
        "model"])
    model = model.to(dev)
    ref = JAX_LMPC_EVAL

    def t(x):
        return torch.tensor(x, dtype=f64, device=dev)

    four = [t([[0.0, 0.0], [2.0, 0.0], [2.5, 2.5], [0.0, 0.0]]),
            t([1.0, 2.0, 1.0, 2.0]), t([0.1, 0.05, 0.2, 0.1]),
            t([[0.05, -0.03], [-0.04, 0.02], [0.03, 0.05], [-0.05, -0.05]])]
    with plain_riccati_on_card() as plain:
        riccati_backward.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, (ps, us) = evaluate.make_lmpc_evaluator(model, **LMPC_EVAL)(
            *four, t(ref["init_k"]))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ric = riccati_backward.launches
    m = res.metrics
    n_ctrl = LMPC_EVAL["n_steps"] // LMPC_EVAL["control_every"]
    inf = float("inf")
    def jx(k):
        return torch.tensor(ref[k], dtype=f64)

    diffs = {
        "ps": _max_diff(ps, jx("ps"), False),
        "us": _max_diff(us, jx("us"), False),
        "final_p": _max_diff(res.final_p, jx("final_p"), False),
        **{k: _max_diff(getattr(m, k), jx(k), False)
           for k in ("steady_state_error", "control_effort", "min_error")}}
    conv_t = [inf if x is None else x for x in ref["convergence_time"]]
    same_flags = (m.converged.tolist() == ref["converged"]
                  and res.contact_lost.tolist() == ref["contact_lost"]
                  and m.convergence_time.tolist() == conv_t)
    top = max(diffs, key=diffs.get)
    print(f"[lmpc-eval] make_lmpc_evaluator float64, lagplant_r5, 4 rows x "
          f"{n_ctrl} control periods (N={LMPC_EVAL['N']}, "
          f"{LMPC_EVAL['max_iters']} iterations): {secs:.2f} s, "
          f"{secs / n_ctrl * 1e3:.1f} ms a control period, {ric} Riccati "
          f"launches; against JAX largest difference {diffs[top]:.3e} "
          f"({top}; gate {LMPC_EVAL_TOL:.0e}), flags and convergence times "
          f"equal {same_flags}; final p {res.final_p.tolist()} [{card}]")
    if not (diffs[top] <= LMPC_EVAL_TOL and same_flags):
        raise AssertionError(f"lmpc-eval: the card differs from JAX: "
                             f"{diffs}, flags equal {same_flags}")
    if ric == 0 or plain[0] != 0:
        raise AssertionError(f"lmpc-eval: {ric} Riccati launches, "
                             f"{plain[0]} plain calls on the card")
    out = {"ctrl_s": secs / n_ctrl, "launches": ric, "worst": diffs[top]}

    # The commands. Their init_k comes from the port's generator, so their
    # rows are not JAX's; at these lengths every period lies in the 250-step
    # warm-up, where no control reaches the plant and the printed metrics
    # read only the starting offset. So the gates read the solves: every
    # `LMPC.solve` call's parameter vector (the policy's output) and
    # controls, the card's against the same command's on `--cpu`.
    env_argv = ["lmpc", "--test", "--env", "cube_1x0_0x1",
                "--checkpoint_dir", str(TUNERS / "lagplant_r5"),
                "--eval_episode_steps", str(LMPC_ENV_STEPS)]
    runs = []
    for extra in ([], ["--cpu"]):
        with lmpc_solve_watch() as log:
            rc, text, ric, reads, wall = run_cli_text(env_argv + extra)
        runs.append((rc, json.loads(text.splitlines()[-1]), log, ric, reads,
                     wall))
    (rc, r, log, ric, reads, wall), (rc_c, r_c, log_c, _, _, _) = runs
    init_k = trainer.sample_init_k(torch.Generator().manual_seed(3), 1,
                                   ppo_mod.ParamActionConfig()).double()
    d_k, d_u = _solves_diff(log, log_c)
    acted = float((log[0][0] - init_k).abs().max())
    u_max = max(float(u.abs().max()) for _, u in log)
    print(f"[lmpc-eval] lmpc --test --env cube_1x0_0x1 ({LMPC_ENV_STEPS} "
          f"control periods, all in the 250-step warm-up: the metrics read "
          f"the starting offset): rc {rc}, {r}; {wall / LMPC_ENV_STEPS * 1e3:.1f}"
          f" ms a control period, {ric} Riccati launches, {reads} host "
          f"reads [{card}]")
    print(f"[lmpc-eval]   its {len(log)} solves float32, card vs --cpu "
          f"({len(log_c)} solves, rc {rc_c}): parameter vectors "
          f"{d_k:.3e} (largest difference over max(|k|, 1); gate "
          f"{LMPC_ENV_K_RTOL:.0e}), controls {d_u:.3e} rad (gate "
          f"{LMPC_ENV_U_TOL:.0e}); the policy moved the start vector by "
          f"{acted:.3e} at the first solve, largest |u| {u_max:.4f} rad")
    if rc != 0 or rc_c != 0 or r != r_c or not np.isfinite(
            r["steady_state_error_mm"]):
        raise AssertionError(f"lmpc --test --env: rc {rc}/{rc_c}, {r}, "
                             f"{r_c}")
    if not (len(log) == len(log_c) == LMPC_ENV_STEPS
            and d_k <= LMPC_ENV_K_RTOL and d_u <= LMPC_ENV_U_TOL
            and acted > 0 and u_max > 0):
        raise AssertionError(f"lmpc --test --env: solves card vs CPU "
                             f"{d_k}, {d_u}; policy moved {acted}, |u| "
                             f"{u_max}")
    out["env"] = {"ctrl_s": wall / LMPC_ENV_STEPS, "d_k": d_k, "d_u": d_u}

    sweep_argv = ["sweep", "--controller", "lmpc", "--runtime",
                  str(LMPC_SWEEP_RUNTIME)]
    with lmpc_solve_watch() as log:
        rc, text, ric, reads, wall = run_cli_text(sweep_argv)
    rows = json.loads(text)["scenarios"]
    u_max = max(float(u.abs().max()) for _, u in log)
    finite = all(bool(torch.isfinite(k).all() and torch.isfinite(u).all())
                 for k, u in log)
    print(f"[lmpc-eval] sweep --controller lmpc --runtime "
          f"{LMPC_SWEEP_RUNTIME} (the general tuner, 18 rows as lanes, "
          f"float32, inside the warm-up): rc {rc}, {wall:.1f} s wall, "
          f"{ric} Riccati launches, {reads} host reads, {len(log)} solves, "
          f"finite {finite}, largest |u| {u_max:.4f} rad; each row's init_k "
          f"from the port's generator seeded with JAX's per-row formula, "
          f"so the rows are not JAX's [{card}]")
    for row in rows:
        print(f"[lmpc-eval]   {row['object']:8s} m={row['mass']:.0f} "
              f"mu={row['mu']:.2f}: sse {row['sse_mm']} mm, effort "
              f"{row['effort']}")
    if rc != 0 or len(rows) != 18 or not all(
            np.isfinite(x["sse_mm"]) for x in rows) or not (
            finite and u_max > 0 and len(log) == LMPC_SWEEP_PERIODS):
        raise AssertionError(f"sweep --controller lmpc: rc {rc}, {len(log)} "
                             f"solves, finite {finite}, |u| {u_max}")
    out["sweep_s"] = wall
    # The same command in float64, card against --cpu: every solve's
    # parameter vectors and controls, and the rows.
    runs = []
    for extra in (["--f64"], ["--f64", "--cpu"]):
        with lmpc_solve_watch() as log:
            rc, text, _, _, wall = run_cli_text(sweep_argv + extra)
        runs.append((rc, json.loads(text)["scenarios"], log, wall))
    (rc, rows, log, wall), (rc_c, rows_c, log_c, wall_c) = runs
    d_k, d_u = _solves_diff(log, log_c)
    print(f"[lmpc-eval] sweep --controller lmpc --f64: card {wall:.1f} s, "
          f"--cpu {wall_c:.1f} s (rc {rc}/{rc_c}); {len(log)} solves, card "
          f"vs --cpu parameter vectors {d_k:.3e}, controls {d_u:.3e} rad "
          f"(gate {LMPC_EVAL_TOL:.0e}), rows equal {rows == rows_c}")
    if not (rc == rc_c == 0 and rows == rows_c and len(log) == len(log_c)
            == LMPC_SWEEP_PERIODS and max(d_k, d_u) <= LMPC_EVAL_TOL):
        raise AssertionError(f"sweep --controller lmpc --f64: card vs CPU "
                             f"{d_k}, {d_u}, rows equal {rows == rows_c}")
    out["sweep_f64"] = {"d_k": d_k, "d_u": d_u}
    return out


# The dual-arm stack: the world step's layers on the card against the same
# calls on CPU tensors, the `pmpc --full_stack` command against JAX's own,
# and the full-stack LMPC trainer.
ARM_B = 4096                # random lanes of each chain
ARM_F64_RTOL = 1e-10
# float32: the card's distance from the CPU's float64 result at most this
# many times the CPU's own float32 distance from it (floor 1e-6 relative).
ARM_F32_FACTOR = 10
WORLD_STEPS_TIMED = 50
# The command: 260 world steps, two control steps after its 250 at rest.
FULL_STACK_RUNTIME = 0.52
FS_CLI_WARMUP = 250
# run_full_stack card vs CPU in float64: two control steps after a 40-step
# warm-up, short enough that the joints' friction chatter
# (tests/test_torch_full_stack.py) has not grown round-off past the gate.
FS_EPISODE_STEPS, FS_EPISODE_WARMUP = 50, 40
FS_EPISODE_TOL = 1e-9
# JAX's own `python -m dart_tpu.cli pmpc --full_stack --cpu --runtime
# FULL_STACK_RUNTIME` (float32, --f64, --f64 --no_tune), and how far a
# 1-ulp change of one of its 14 initial joint angles moves its float64
# error (m) and effort (relative): `JAX_PLATFORMS=cpu PYTHONPATH=. python
# tests/test_torch_full_stack.py`.
JAX_FULL_STACK = {
    "float32": {
        "converged": False,
        "steady_state_error": 0.06410615648084447,
        "control_effort": 0.009006033651530743
    },
    "float64": {
        "converged": False,
        "steady_state_error": 0.06410622722468579,
        "control_effort": 0.009023591892329777,
        "witness": {
            "sse_max": 3.9602632589952336e-08,
            "sse_median": 1.1329181488772821e-08,
            "effort_rel_max": 0.0014000812866061807,
            "effort_rel_median": 0.00033821624919500026
        }
    },
    "float64_no_tune": {
        "converged": False,
        "steady_state_error": 0.06410977133873949,
        "control_effort": 0.005073183750324275,
        "witness": {
            "sse_max": 2.898027245956669e-08,
            "sse_median": 1.0202958422578234e-08,
            "effort_rel_max": 0.0008301815525513234,
            "effort_rel_median": 0.00044623095350421194
        }
    }
}
# The float32 command within FS_F32_FACTOR x JAX's own float32-vs-float64
# gap; the float64 ones within FS_F64_FACTOR x the largest 1-ulp change.
FS_F32_FACTOR = 10
FS_F64_FACTOR = 10
# The command in float32 at its defaults, and once in float64 with the
# general weights and the npz log.
# The float32 command also renders its episode (`--video`): the video
# phase reads that run (`check_fs_video`) rather than running four more
# episodes.
FS_CLI = (("float32", ["--video"]),
          ("float64_no_tune", ["--f64", "--no_tune", "--log_dir"]))
# The full-stack trainer (tools/train_lmpc_fullstack.py's settings).
FST_B = 8
FST_N = 8
FST_STEPS = 2               # float64 env_steps held card vs CPU
FST_TOL = 1e-9
FST_UPDATES = 1
FST_ROLLOUT = 2


def _rel_err(got, want) -> float:
    """`_max_diff` relative to |want|, the largest over a tuple's
    tensors."""
    if isinstance(got, tuple):
        return max(_rel_err(g, w) for g, w in zip(got, want))
    return _max_diff(got, want, True)


@contextlib.contextmanager
def sync_watch():
    """Count the card's synchronising calls (torch's sync debug mode) made
    in the block, by the line of this repo's code that made them."""
    import collections
    import warnings

    torch.cuda.synchronize()
    box = collections.Counter()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield box
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in seen:
        if "synchroniz" in str(w.message):
            box[f"{Path(w.filename).name}:{w.lineno}"] += 1


def _arm_inputs(dtype: torch.dtype, dev: torch.device, n: int):
    """Random lanes of both chains (2, n, ...) near the home pose, drawn
    from a seeded numpy generator: joints, rates, torques, EE wrenches, a
    QP per lane (tests/test_arm.py's construction) and EE targets."""
    from dart_tpu_torch.rollout import full_stack as fs

    rng = np.random.default_rng(21)
    home = np.asarray([fs.HOME_QL, fs.HOME_QR])
    q = home[:, None] + rng.uniform(-0.6, 0.6, (2, n, 7))
    qd = rng.normal(size=(2, n, 7)) * 0.5
    tau = rng.normal(size=(2, n, 7)) * 10.0
    f_ext = rng.normal(size=(2, n, 6)) * 5.0
    L = rng.normal(size=(n, 7, 7))
    P = L @ L.transpose(0, 2, 1) + np.eye(7)
    qv = rng.normal(size=(n, 7))
    A = rng.normal(size=(n, 21, 7))
    c = np.einsum("bij,bj->bi", A, rng.normal(size=(n, 7))) * 0.1
    w = rng.uniform(0.5, 2.0, (n, 21))
    dpos = rng.normal(size=(2, n, 3)) * 0.02
    dquat = rng.normal(size=(2, n, 4)) * 0.05
    return [torch.from_numpy(x).to(dev, dtype) for x in (
        q, qd, tau, f_ext, P, qv, A, c - w, c + w, dpos, dquat)]


def _arm_calls(scene, dtype: torch.dtype, dev: torch.device, n: int):
    """The world step's layers on n lanes of both chains: {name: result}."""
    from dart_tpu_torch.control import arm as arm_mod
    from dart_tpu_torch.ops import qp
    from dart_tpu_torch.physics import chain
    from dart_tpu_torch.rollout import full_stack as fs
    from dart_tpu_torch.utils.quat import quat_normalize

    q, qd, tau, f_ext, P, qv, A, lo, hi, dpos, dquat = _arm_inputs(
        dtype, dev, n)
    arms = fs._arms(scene)
    out = {}
    with torch.no_grad():
        out["fk"] = tuple(chain.fk(arms, q))
        out["mass_matrix"] = chain.mass_matrix(arms, q)
        out["bias_forces"] = chain.bias_forces(arms, q, qd)
        out["jac_and_jacdot"] = chain.jac_and_jacdot(arms, q, qd, 7,
                                                     fs.EE_OFFSET)
        out["forward_dynamics"] = chain.forward_dynamics(arms, q, qd, tau,
                                                         f_ext=f_ext)
        out["step"] = chain.step(arms, q, qd, tau, DT, f_ext=f_ext)
        sol = qp.solve_qp_admm(P, qv, A, lo, hi, iters=40)
        out["solve_qp_admm"] = (sol.x, sol.y)
        dyn, _ = fs._snapshot(arms, q, qd)
        pos, quat = dyn.ee_pos, dyn.ee_quat
        carry = arm_mod.arm_init_carry(dtype, dev, (2, n))
        c2, tq, _ = arm_mod.compute_torque(
            carry, dyn, pos + dpos, quat_normalize(quat + dquat),
            scene.arm_params, qp_iters=40)
        out["compute_torque"] = (c2.qdd_prev, c2.y, tq)
    return out


def _world_step_numbers(scene, st, u, op, card: str, label: str) -> dict:
    """One `full_step` (qp_iters 40): host-clock ms over WORLD_STEPS_TIMED
    steps, the card's synchronising calls in one step, and the device ops
    and busy time per step under the profiler."""
    from dart_tpu_torch.rollout import full_stack as fs

    def step():
        return fs.full_step(scene, st, u, op, DT, qp_iters=40)

    with torch.no_grad():
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WORLD_STEPS_TIMED):
            step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / WORLD_STEPS_TIMED * 1e3
        with sync_watch() as syncs:
            step()
        traced_steps(step, 10, card, label)
    n_sync = sum(syncs.values())
    print(f"[{label}] full_step B={st.qL.shape[0]} "
          f"{str(st.qL.dtype)[6:]}: {ms:.3f} ms a world step (host clock, "
          f"{WORLD_STEPS_TIMED} steps); {n_sync} synchronising calls a step"
          f" {dict(syncs)} [{card}]")
    return {"ms": ms, "syncs": n_sync, "where": dict(syncs)}


def phase_arm(dev: torch.device, card: str) -> dict:
    """The world step's layers (chain FK, mass matrix, bias forces, Jdot,
    forward dynamics and step with an EE wrench, the ADMM QP, the impedance
    controller on `_arm_dynamics` snapshots) on ARM_B random lanes of each
    chain on the card against the same calls on CPU tensors: float64 to
    ARM_F64_RTOL relative, float32 within ARM_F32_FACTOR x the CPU's own
    float32 distance from its float64 result. Then one world step at
    B=ARM_B (the full-stack phase takes B=1): ms, synchronising calls,
    device ops."""
    from dart_tpu_torch.physics import tray_object as to_mod
    from dart_tpu_torch.rollout import full_stack as fs

    cpu = torch.device("cpu")
    res = {}
    ref = _arm_calls(fs.make_scene(DT, torch.float64, cpu), torch.float64,
                     cpu, ARM_B)
    for dtype in (torch.float64, torch.float32):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_out = _arm_calls(fs.make_scene(DT, dtype, dev), dtype, dev,
                              ARM_B)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        cpu32 = None if dtype == torch.float64 else _arm_calls(
            fs.make_scene(DT, dtype, cpu), dtype, cpu, ARM_B)
        for name in card_out:
            err = _rel_err(card_out[name], ref[name])
            if dtype == torch.float64:
                gate = ARM_F64_RTOL
                print(f"[arm] {name} B=2x{ARM_B} float64: card vs CPU "
                      f"{err:.3e} relative (gate {gate:.0e})")
            else:
                own = _rel_err(cpu32[name], ref[name])
                gate = ARM_F32_FACTOR * max(own, 1e-6)
                print(f"[arm] {name} B=2x{ARM_B} float32: card vs the CPU's "
                      f"float64 {err:.3e} relative, the CPU's float32 "
                      f"{own:.3e} (gate {gate:.3e})")
            if not err <= gate:
                raise AssertionError(f"arm: {name} {str(dtype)[6:]} {err} "
                                     f"> {gate}")
            res[(name, str(dtype)[6:])] = err
        print(f"[arm] all layers at B=2x{ARM_B} {str(dtype)[6:]}: "
              f"{card_s:.2f} s on the card, first call [{card}]")
    scene = fs.make_scene(DT, torch.float32, dev)
    op = to_mod.make_params("cube", 1.0, 0.1, dtype=torch.float32,
                            device=dev)
    st = fs.init_full_state(torch.float32, device=dev, batch=ARM_B)
    u = torch.full((ARM_B, 2), 0.05, dtype=torch.float32, device=dev)
    return {"errs": res,
            "world": _world_step_numbers(scene, st, u, op, card, "arm")}


def _fs_episode(dev: torch.device, dtype: torch.dtype):
    """`run_full_stack` with the `pmpc --full_stack` command's controller
    and scene (cube, 1 kg, mu 0.1, target (0.05, -0.04)) for
    FS_EPISODE_STEPS after FS_EPISODE_WARMUP at rest; returns (positions,
    tilts, controls) (1, T, 2) each and the host-clock seconds."""
    from dart_tpu_torch.control import mpc as mpc_mod
    from dart_tpu_torch.models import dynamics as dyn
    from dart_tpu_torch.physics import tray_object as to_mod
    from dart_tpu_torch.rollout import full_stack as fs

    scene = fs.make_scene(DT, dtype, dev)
    op = to_mod.make_params("cube", 1.0, 0.1, dtype=dtype, device=dev)
    ctlr = mpc_mod.PMPC(N=15, dt=DT, u_bound=0.6,
                        cfg=mpc_mod.ilqr.ILQRConfig(max_iters=10))
    w = mpc_mod.pmpc_schedule_weights(
        mpc_mod.PMPC_WEIGHTS["cube"], torch.tensor(0.1, dtype=dtype,
                                                   device=dev), True)
    params = dyn.PMPCParams(mu=0.1, dt=DT)
    t6 = torch.tensor([[0.05, 0, -0.04, 0, 0.43, 0]], dtype=dtype,
                      device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    ps, th, us, _ = fs.run_full_stack(
        scene, lambda c, o, t: ctlr.solve(c, o, t, params, w),
        ctlr.init_carry(1, dtype, dev), fs.init_full_state(dtype, device=dev),
        t6, op, FS_EPISODE_STEPS, dt=DT, control_every=5,
        warmup_steps=FS_EPISODE_WARMUP, qp_iters=40)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return [x.cpu() for x in (ps, th, us)], time.perf_counter() - t0


def phase_full_stack(dev: torch.device, card: str) -> dict:
    """(a) `run_full_stack` with the command's PMPC `solve_fn` in float64 on
    the card against the same call on CPU tensors (FS_EPISODE_TOL), every
    backward pass a Riccati launch; (b) the world step at B=1 in float32:
    ms, device ops, synchronising calls; (c) `python -m dart_tpu_torch.cli pmpc
    --full_stack --runtime FULL_STACK_RUNTIME` in float32 and in float64
    with --no_tune and --log_dir, gated on JAX's own commands
    (JAX_FULL_STACK): `converged` equal, the error and effort within
    FS_F32_FACTOR x JAX's float32-vs-float64 gap (float32) or FS_F64_FACTOR
    x JAX's largest 1-ulp change (float64)."""
    from dart_tpu_torch.ops.kernels.riccati import riccati_backward
    from dart_tpu_torch.physics import tray_object as to_mod
    from dart_tpu_torch.rollout import full_stack as fs
    from dart_tpu_torch.solver import ilqr

    out = {}
    with plain_riccati_on_card() as plain:
        riccati_backward.launches, ilqr.host_bool.count = 0, 0
        (ps, th, us), card_s = _fs_episode(dev, torch.float64)
        ric, reads = riccati_backward.launches, ilqr.host_bool.count
        (ps_c, th_c, us_c), cpu_s = _fs_episode(torch.device("cpu"),
                                                torch.float64)
        gap = {k: float((a - b).abs().max()) for k, a, b in (
            ("p", ps, ps_c), ("theta", th, th_c), ("u", us, us_c))}
        print(f"[full-stack] run_full_stack float64, {FS_EPISODE_STEPS} "
              f"world steps (2 control steps after {FS_EPISODE_WARMUP}): "
              f"card vs CPU {gap} (gate {FS_EPISODE_TOL:.0e}); "
              f"{card_s:.1f} s on the card, {cpu_s:.1f} s on the CPU; {ric} "
              f"Riccati launches, {reads} host reads [{card}]")
        if not max(gap.values()) <= FS_EPISODE_TOL:
            raise AssertionError("full-stack: the card's episode differs "
                                 "from the CPU's")
        if not 0 < ric <= 20:
            raise AssertionError(f"full-stack: {ric} Riccati launches")
        out["episode"] = {**gap, "card_s": card_s, "launches": ric}

        scene = fs.make_scene(DT, torch.float32, dev)
        op = to_mod.make_params("cube", 1.0, 0.1, dtype=torch.float32,
                                device=dev)
        st = fs.init_full_state(torch.float32, device=dev)
        u = torch.tensor([[0.05, -0.02]], dtype=torch.float32, device=dev)
        out["world"] = _world_step_numbers(scene, st, u, op, card,
                                           "full-stack")

        R = FULL_STACK_RUNTIME
        n_steps = int(R / DT)
        solves = -(-(n_steps - FS_CLI_WARMUP) // 5)
        for name, extra in FS_CLI:
            ref = JAX_FULL_STACK[name]
            with tempfile.TemporaryDirectory() as tmp:
                argv = ["pmpc", "--full_stack", "--runtime", str(R)]
                for a in extra:
                    argv += ([a, tmp] if a == "--log_dir" else
                             [a, str(Path(tmp) / "fs.mp4")] if a == "--video"
                             else [a])
                rc, res, ric, reads, wall = run_cli(argv)
                if "--video" in extra:
                    out["video"] = check_fs_video(rc, res, ric, wall, card)
                if "--log_dir" in extra:
                    log = np.load(res["log_path"])
                    keys = sorted(log.files)
                    sse = float(log["steady_state_error"])
                    print(f"[full-stack] --log_dir: {keys}, X "
                          f"{log['X'].shape}, steady_state_error {sse}")
                    if not (log["X"].shape == (n_steps, 6)
                            and {"t", "U_cmd", "control_effort"} <= set(keys)
                            and abs(sse - res["steady_state_error"])
                            <= 1e-12):
                        raise AssertionError("full-stack: the npz log is "
                                             "wrong")
            if name == "float32":
                r64 = JAX_FULL_STACK["float64"]
                sse_tol = FS_F32_FACTOR * abs(ref["steady_state_error"]
                                              - r64["steady_state_error"])
                eff_tol = FS_F32_FACTOR * abs(ref["control_effort"]
                                              / r64["control_effort"] - 1)
            else:
                sse_tol = FS_F64_FACTOR * ref["witness"]["sse_max"]
                eff_tol = FS_F64_FACTOR * ref["witness"]["effort_rel_max"]
            d_sse = abs(res["steady_state_error"] - ref["steady_state_error"])
            d_eff = abs(res["control_effort"] / ref["control_effort"] - 1)
            print(f"[full-stack] pmpc --full_stack {' '.join(extra)} "
                  f"--runtime {R}: rc {rc}, converged {res['converged']} "
                  f"(JAX {ref['converged']}), steady-state error "
                  f"{res['steady_state_error']} m (JAX "
                  f"{ref['steady_state_error']}, difference {d_sse:.3e}, gate "
                  f"{sse_tol:.3e}), control effort {res['control_effort']} "
                  f"(JAX {ref['control_effort']}, relative difference "
                  f"{d_eff:.3e}, gate {eff_tol:.3e}); first call "
                  f"{res['compile_s']} s, {res['run_s']} s an episode, "
                  f"{wall:.1f} s wall for 4 episodes; "
                  f"{ric / 4 / solves:.1f} Riccati launches and "
                  f"{reads / 4 / solves:.1f} host reads a control step "
                  f"[{card}]")
            if rc != 0 or res["converged"] != ref["converged"]:
                raise AssertionError(f"full-stack {name}: rc {rc}, converged "
                                     f"{res['converged']}")
            if not (d_sse <= sse_tol and d_eff <= eff_tol):
                raise AssertionError(f"full-stack {name}: the command differs"
                                     " from JAX's")
            if ric == 0:
                raise AssertionError(f"full-stack {name}: no Riccati launch")
            out[name] = {"run_s": res["run_s"], "wall": wall,
                         "launches": ric / 4 / solves,
                         "reads": reads / 4 / solves}
    print(f"[full-stack] plain Riccati calls on the card {plain[0]} (gate 0)")
    if plain[0] != 0:
        raise AssertionError("riccati_backward_reference ran on the card")
    return out


def _fst_setup(dev: torch.device, dtype: torch.dtype, gen: torch.Generator):
    """The full-stack trainer at tools/train_lmpc_fullstack.py's settings:
    LMPC(N=8, dt=0.01, 4 iterations), FSEnvConfig(substeps=5, qp_iters=20),
    FST_B envs; the converted fullstack_r5 tuner cast to `dtype`; the
    start and FST_STEPS steps of draws from `gen`."""
    from dart_tpu_torch.adapt import lmpc_fullstack as fst
    from dart_tpu_torch.adapt import lmpc_trainer as trainer
    from dart_tpu_torch.adapt import ppo as ppo_mod
    from dart_tpu_torch.control import mpc as mpc_mod
    from dart_tpu_torch.io import checkpoint as ckpt
    from dart_tpu_torch.rollout import full_stack as fs

    ctlr = mpc_mod.LMPC(N=FST_N, dt=0.01,
                        cfg=mpc_mod.ilqr.ILQRConfig(max_iters=4))
    cfg = fst.FSEnvConfig(dt=DT, substeps=5, qp_iters=20)
    scene = fs.make_scene(DT, dtype, dev)
    model = ppo_mod.ActorCritic(trainer.N_PARAMS, trainer.OBS_DIM)
    model.load_state_dict(ckpt.load_agent(str(TUNERS / "fullstack_r5"))[
        "model"])
    model = model.to(dev, dtype)
    s0 = fst.env_init(ctlr, cfg, FST_B, dtype, dev, gen=gen)
    draws = [fst.draw_step(gen, FST_B, cfg, dtype, dev)
             for _ in range(FST_STEPS)]
    return model, ctlr, scene, cfg, s0, draws


def phase_fullstack_train(dev: torch.device, card: str) -> dict:
    """The full-stack LMPC trainer: (a) FST_STEPS float64 `env_step`s of
    FST_B envs with the converted fullstack_r5 tuner on the card against
    the same calls on CPU tensors with the same CPU-drawn inputs (FST_TOL
    on every state leaf and the transitions), every backward pass a
    Riccati launch; (b) `make_train_step(replay=True)` for FST_UPDATES
    updates of FST_B envs x FST_ROLLOUT steps in float32 from a fresh
    policy: finite losses, moved parameters; seconds a train step and a
    control step, Riccati launches a train step."""
    from dart_tpu_torch.adapt import lmpc_fullstack as fst
    from dart_tpu_torch.adapt import lmpc_trainer as trainer
    from dart_tpu_torch.adapt import ppo as ppo_mod
    from dart_tpu_torch.ops.kernels.riccati import riccati_backward
    from dart_tpu_torch.solver import ilqr

    out = {}
    with plain_riccati_on_card() as plain:
        runs = []
        for d in (dev, torch.device("cpu")):
            model, ctlr, scene, cfg, s, draws = _fst_setup(
                d, torch.float64, torch.Generator().manual_seed(17))
            riccati_backward.launches = 0
            if d.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            trs = []
            for dr in draws:
                s, tr = fst.env_step(model, ctlr, scene, s, cfg, dr)
                trs.append(tr)
            if d.type == "cuda":
                torch.cuda.synchronize()
            runs.append((s, trs, time.perf_counter() - t0,
                         riccati_backward.launches))
        (sc, trc, secs, ric), (sp, trp, cpu_s, _) = runs
        worst = {name: _max_diff(a, b, False) for (name, a), (_, b) in zip(
            [*_leaves(sc, "state.")] + [
                (f"tr{i}.{n}", x) for i, t in enumerate(trc)
                for n, x in _leaves(t)],
            [*_leaves(sp, "state.")] + [
                (f"tr{i}.{n}", x) for i, t in enumerate(trp)
                for n, x in _leaves(t)])}
        top = max(worst, key=worst.get)
        print(f"[fullstack-train] env_step B={FST_B} N={FST_N} float64 with "
              f"fullstack_r5, {FST_STEPS} steps of 5 world steps: card vs "
              f"CPU largest difference {worst[top]:.3e} ({top}; gate "
              f"{FST_TOL:.0e}); {secs / FST_STEPS * 1e3:.1f} ms a control "
              f"step on the card (CPU {cpu_s / FST_STEPS * 1e3:.1f}), {ric} "
              f"Riccati launches [{card}]")
        if not worst[top] <= FST_TOL:
            raise AssertionError(f"fullstack-train: {top} {worst[top]}")
        if ric == 0:
            raise AssertionError("fullstack-train: no Riccati launch")
        out["env_step"] = {"worst": worst[top], "ctrl_s_f64": secs / FST_STEPS}

        gen = torch.Generator().manual_seed(0)
        pcfg = ppo_mod.PPOConfig(epochs=4, minibatch_size=64)
        ts = trainer.init_train_state(gen, pcfg, dev)
        _, ctlr, scene, cfg, s, _ = _fst_setup(dev, torch.float32, gen)
        step = fst.make_train_step(ctlr, scene, cfg, pcfg, FST_ROLLOUT,
                                   replay=True)
        buf = trainer.init_replay(FST_B, FST_ROLLOUT, torch.float32, dev)
        before = [p.detach().clone() for p in ts.model.parameters()]
        times, launches, stats = [], [], []
        for _ in range(FST_UPDATES):
            riccati_backward.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ts, s, buf, st = step(ts, s, buf)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches.append(riccati_backward.launches)
            stats.append({k: float(v) for k, v in st.items()})
        with torch.no_grad():
            moved = sum(float((p - q).abs().sum()) for p, q in
                        zip(ts.model.parameters(), before))
        print(f"[fullstack-train] make_train_step(replay=True) {FST_UPDATES} "
              f"updates of {FST_B} envs x {FST_ROLLOUT} steps float32: "
              f"{[round(t, 2) for t in times]} s a train step, "
              f"{times[-1] / FST_ROLLOUT * 1e3:.1f} ms a control step with "
              f"the PPO update spread over it, Riccati launches a train step "
              f"{launches} (at most 4 x {FST_ROLLOUT}); stats {stats}; "
              f"parameters moved by {moved:.3e} [{card}]")
        if not (moved > 0 and all(np.isfinite(v) for s_ in stats
                                  for v in s_.values())
                and all(0 < x <= 4 * FST_ROLLOUT for x in launches)):
            raise AssertionError("fullstack-train: the train step failed")
        out["train"] = {"step_s": times, "launches": launches}
        # The kernel at the trainer's shape, float32, about the state the
        # train steps reached.
        from dart_tpu_torch.control import mpc as mpc_mod
        from dart_tpu_torch.rollout import full_stack as fs

        aux, z0 = ctlr._problem(s.ctrl_carry, fs.observe_object_8(
            s.world, s.obj_params), s.target, mpc_mod.LMPC_DEFAULT_WEIGHTS)
        out["riccati"] = riccati_at(ctlr.ocp, s.current_k, aux, z0,
                                    s.ctrl_carry.V, card, "fullstack-train")
    print(f"[fullstack-train] plain Riccati calls on the card {plain[0]} "
          "(gate 0)")
    if plain[0] != 0:
        raise AssertionError("riccati_backward_reference ran on the card")
    return out


# ---------------------------------------------------------------------------
# MPPI, the learned-dynamics OCP, telemetry streaming and video
# ---------------------------------------------------------------------------

MPPI_F64_B = 8             # lanes of the float64 card-vs-CPU episode
MPPI_F64_STEPS = 265       # three control steps after the 250 at rest
MPPI_TOL = 1e-9
MPPI_SWEEP_RUNTIME = 0.6   # sweep --controller mppi: 11 control steps
NEURAL_STEPS = 20          # closed-loop control steps through the network
NEURAL_TOL = 1e-9
STREAM_RUNTIME = 0.52      # pmpc --stream: 260 sim steps, 2 control steps
PREVIEW_OBJECT = "apple"        # a pack preset that rolls under the tilt
PREVIEW_SECONDS = 0.5      # preview: 250 plant steps, 13 frames


def _mppi_problem(sc, dev: torch.device):
    """One control step of the MPPI evaluator at B lanes from rest: its
    OCP, config, params, aux and a shared draw, float32."""
    from dart_tpu_torch.models import dynamics as dyn
    from dart_tpu_torch.physics import tray_object as to
    from dart_tpu_torch.rollout import evaluate
    from dart_tpu_torch.solver import mppi
    from dart_tpu_torch.solver.ocp import PMPCAux, make_pmpc_ocp

    ocp = make_pmpc_ocp(dt=DT, u_bound=0.6)
    cfg = mppi.MPPIConfig(n_samples=256, temperature=0.05, sigma=0.08,
                          n_iters=2)
    w = evaluate._select_weights(to.shape_from_kappa(sc.kappa_inv),
                                 torch.float32)
    zero = torch.zeros(B, dtype=torch.float32, device=dev)
    t6 = torch.stack([sc.target_xy[:, 0], zero, sc.target_xy[:, 1], zero,
                      zero + 0.43, zero], -1)
    aux = PMPCAux(target=t6, Qp=w.Qp, Qv=w.Qv, R=w.R)
    params = dyn.PMPCParams(mu=sc.mu, dt=DT)
    gen = torch.Generator(device=dev).manual_seed(0)
    noise = mppi.draw_noise(cfg, gen, (), N, 2, torch.float32, dev)
    z0 = torch.zeros((B, 6), dtype=torch.float32, device=dev)
    U = torch.zeros((B, N, 2), dtype=torch.float32, device=dev)
    return ocp, cfg, params, aux, z0, U, noise


def phase_mppi_eval(dev: torch.device, card: str) -> dict:
    """(a) `make_mppi_evaluator()` at its defaults (N=15, u_bound 0.6,
    K=256 x 2 iterations, temperature 0.05, sigma 0.08, a solve every 5
    steps after 250 at rest, one draw a control step shared by the lanes)
    on the calibrated contact plant, 2500 steps at B=4096 rows of
    `random_scenarios(default_rng(0))`, float32, watched for the gates
    (finite controls within |u| <= 0.6 + 1e-6) and timed;
    one control step's device ops and idle share (torch.profiler); (b) the
    evaluator in float64 on MPPI_F64_B lanes for MPPI_F64_STEPS steps, the
    card against CPU tensors fed the same CPU-drawn perturbations
    (MPPI_TOL); (c) `sweep --controller mppi --runtime MPPI_SWEEP_RUNTIME`:
    exit 0 and 18 finite rows."""
    from dart_tpu_torch.io import scenes
    from dart_tpu_torch.rollout import evaluate
    from dart_tpu_torch.solver import mppi

    sc = eval_scenarios(dev)
    ev = evaluate.make_mppi_evaluator()
    # One watched run: the watch costs ~0.5% of an episode here (30.736 s
    # unwatched, 30.882 s watched in the phase's first call).
    with plant_watch(dev) as w:
        res, wall = timed_eval(ev, sc)
    out = eval_report("mppi-eval", res, res, w, wall, None,
                      plant_step_ms(sc, dev), card, 0.6)
    print(f"[mppi-eval] {wall:.3f} s an episode of {EVAL_STEPS} steps at "
          f"B={B} (K=256 rollouts x 2 iterations a lane and solve: "
          f"{B * 256} rollouts of {N} stages each) [{card}]")
    ocp, cfg, params, aux, z0, U, noise = _mppi_problem(sc, dev)
    with torch.no_grad():
        mppi.solve(ocp, cfg, params, aux, z0, U, noise)
        torch.cuda.synchronize()
        traced_steps(lambda: mppi.solve(ocp, cfg, params, aux, z0, U, noise),
                     5, card, f"mppi-eval: one MPPI solve at B={B}")

    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(7)
    draws = [mppi.draw_noise(cfg, gen, (), N, 2, torch.float64, cpu)
             for _ in range(3)]
    rng_sc = scenes.random_scenarios(np.random.default_rng(1), MPPI_F64_B,
                                     dtype=torch.float64, device=cpu)
    runs = []
    for d in (dev, cpu):
        ev64 = evaluate.make_mppi_evaluator(
            n_steps=MPPI_F64_STEPS,
            draw=lambda j, dtype, device: draws[j].to(device))
        r = ev64(*(x.to(d) for x in (rng_sc.kappa_inv, rng_sc.mass,
                                     rng_sc.mu, rng_sc.target_xy)))
        runs.append([r.final_p.cpu(), *(x.cpu() for x in r.metrics)])
    # Every float result, an infinite convergence time equal on both.
    gap = max(float(torch.where(torch.isfinite(b), a - b,
                                (a != b).double()).abs().max())
              for a, b in zip(*runs) if a.is_floating_point())
    print(f"[mppi-eval] float64 B={MPPI_F64_B}, {MPPI_F64_STEPS} steps (3 "
          f"control steps), card vs CPU on the same CPU draws: {gap:.3e} "
          f"(gate {MPPI_TOL:.0e})")
    if not gap <= MPPI_TOL:
        raise AssertionError(f"mppi-eval: card vs CPU {gap}")

    rc, res_cli, _, _, wall_cli = run_cli(
        ["sweep", "--controller", "mppi", "--runtime",
         str(MPPI_SWEEP_RUNTIME)])
    rows = res_cli["scenarios"]
    finite = all(np.isfinite(r["sse_mm"]) and np.isfinite(r["effort"])
                 for r in rows)
    print(f"[mppi-eval] sweep --controller mppi --runtime "
          f"{MPPI_SWEEP_RUNTIME}: rc {rc}, {len(rows)} rows, finite {finite},"
          f" mean sse {res_cli['summary']['mean_sse_mm']} mm, {wall_cli:.1f} "
          f"s wall [{card}]")
    if rc != 0 or len(rows) != 18 or not finite:
        raise AssertionError("mppi-eval: the sweep command failed")
    return {**out, "episode_s": wall, "f64_gap": gap, "sweep_s": wall_cli}


def _neural_plant(x, u):
    """tests/test_neural.py's 4-state tray plant with nonlinear friction,
    batched."""
    vx, vy = x[..., 1], x[..., 3]
    ax = -9.81 * torch.sin(u[..., 0]) - 0.3 * vx - 0.5 * torch.tanh(vx / 0.05)
    ay = -9.81 * torch.sin(u[..., 1]) - 0.3 * vy - 0.5 * torch.tanh(vy / 0.05)
    return torch.stack([vx, ax, vy, ay], -1)


def _neural_solve(nx: int, dev: torch.device, dtype: torch.dtype):
    """One `ilqr.solve` through a random 32-32 network (a seeded
    generator) at nx, three lanes, N=10, 15 iterations."""
    from dart_tpu_torch.models import neural
    from dart_tpu_torch.solver import ilqr

    m = neural.DynamicsMLP(nx, (32, 32), device=dev).reset_parameters(
        torch.Generator().manual_seed(nx)).to(dtype)
    ocp = neural.make_neural_ocp(neural.NeuralModel(m), dt=0.02, nx=nx)
    rng = np.random.default_rng(nx)
    target = np.zeros(nx)
    target[[0, 2]] = [0.06, -0.05]
    Q = np.where(np.arange(nx) % 2 == 0, 200.0, 2.0)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    aux = tuple(t(a) for a in (target, Q, [0.1, 0.1, 1.0, 1.0], Q))
    z0 = t(np.concatenate([rng.normal(size=(3, nx)) * 0.02,
                           rng.uniform(-0.1, 0.1, (3, 2))], -1))
    V0 = t(rng.uniform(-0.2, 0.2, (3, 10, 2)))
    return ilqr.solve(ocp, ilqr.ILQRConfig(max_iters=15),
                      neural.weights(m), aux, z0, V0)


def phase_neural(dev: torch.device, card: str) -> dict:
    """The learned-dynamics path: (a) `fit_dynamics` at tests/test_neural
    .py's size (4096 transitions, 64-64, 3000 Adam steps, batch 256) on the
    card, float32, gated on JAX's mse < 5e-3 and held-out relative error <
    1e-2; (b) the closed loop through the fitted network at nx=4 (nz=6: the
    Riccati kernel) for NEURAL_STEPS control steps, gated on the error
    falling below 1 cm and one `riccati_backward` launch per iteration;
    (c) one `ilqr.solve` at nx=6 (nz=8: the generic backward pass), the
    card against CPU tensors in float64 (NEURAL_TOL), with no Riccati
    launch; (d) `lqr_backward_parallel` against `lqr_backward_sequential`
    on the card."""
    from dart_tpu_torch.models import dynamics as dyn
    from dart_tpu_torch.models import neural
    from dart_tpu_torch.ops import lqr_parallel as lqr
    from dart_tpu_torch.ops.kernels.riccati import riccati_backward
    from dart_tpu_torch.solver import ilqr

    out = {}
    X, U, Y = neural.collect_transitions(
        _neural_plant, np.random.default_rng(0), 4096, 4, device=dev)
    m = neural.DynamicsMLP(4, device=dev).reset_parameters(
        torch.Generator().manual_seed(0))
    nm = neural.NeuralModel(m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w, mse = neural.fit_dynamics(
        nm, neural.weights(m), X, U, Y,
        gen=torch.Generator(device=dev).manual_seed(1), steps=3000)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    Xt, Ut, Yt = neural.collect_transitions(
        _neural_plant, np.random.default_rng(1), 512, 4, device=dev)
    with torch.no_grad():
        pred = neural.neural_xdot(nm, w, Xt, Ut)
    rel = float(((pred - Yt) ** 2).mean() / (Yt ** 2).mean())
    print(f"[neural] fit_dynamics 3000 steps x 256 of 4096 transitions, "
          f"64-64, float32: mse {float(mse):.3e} (gate 5e-3), held-out "
          f"relative {rel:.3e} (gate 1e-2), {fit_s:.2f} s, "
          f"{fit_s / 3000 * 1e3:.3f} ms a step [{card}]")
    if not (float(mse) < 5e-3 and rel < 1e-2):
        raise AssertionError("neural: the fit missed JAX's gates")
    out["fit_s"], out["mse"] = fit_s, float(mse)

    ocp = neural.make_neural_ocp(nm, dt=0.02, nx=4, u_bound=0.4)
    target = torch.tensor([0.06, 0.0, -0.05, 0.0], device=dev)
    aux = (target, torch.tensor([200.0, 2.0, 200.0, 2.0], device=dev),
           torch.tensor([0.1, 0.1, 1.0, 1.0], device=dev),
           torch.tensor([200.0, 2.0, 200.0, 2.0], device=dev))
    cfg = ilqr.ILQRConfig(max_iters=15)
    step = dyn.discretize(lambda x, u, p: _neural_plant(x, u), 0.02)
    x = torch.zeros((1, 4), device=dev)
    V = torch.zeros((1, 15, 2), device=dev)
    errs, iters = [], 0
    riccati_backward.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(NEURAL_STEPS):
        sol = ilqr.solve(ocp, cfg, w, aux,
                         torch.cat([x, torch.zeros((1, 2), device=dev)], -1),
                         V)
        iters += int(sol.iters.sum())
        V = torch.cat([sol.V[:, 1:], sol.V[:, -1:]], 1)
        x = step(x, sol.V[:, 0], None)
        errs.append(float(torch.hypot(x[0, 0] - 0.06, x[0, 2] + 0.05)))
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = riccati_backward.launches
    print(f"[neural] closed loop through the network, nx=4 (nz=6), "
          f"{NEURAL_STEPS} control steps: error {errs[0] * 1e3:.2f} -> "
          f"{errs[NEURAL_STEPS // 2] * 1e3:.2f} -> {errs[-1] * 1e3:.3f} mm "
          f"(gate < 10 mm, falling), {iters} iterations, {launches} "
          f"riccati_backward launches (gate: one an iteration), "
          f"{loop_s / NEURAL_STEPS * 1e3:.1f} ms a control step, "
          f"{loop_s / iters * 1e3:.1f} ms an iteration [{card}]")
    if not (errs[-1] < 0.01 and errs[-1] < errs[0]):
        raise AssertionError("neural: the closed loop did not converge")
    if launches != iters:
        raise AssertionError(f"neural: {launches} Riccati launches for "
                             f"{iters} iterations")
    out.update(ctrl_ms=loop_s / NEURAL_STEPS * 1e3, launches=launches,
               iters=iters, final_err=errs[-1])

    riccati_backward.launches = 0
    card_sol = _neural_solve(6, dev, torch.float64)
    ric = riccati_backward.launches
    cpu_sol = _neural_solve(6, torch.device("cpu"), torch.float64)
    gap = max(float((getattr(card_sol, f).cpu() - getattr(cpu_sol, f))
                    .abs().max()) for f in ("V", "Z", "K", "cost"))
    same_iters = torch.equal(card_sol.iters.cpu(), cpu_sol.iters)
    print(f"[neural] ilqr.solve through the network at nx=6 (nz=8, the "
          f"generic backward pass), 3 lanes, float64: card vs CPU {gap:.3e} "
          f"(gate {NEURAL_TOL:.0e}), iterations {card_sol.iters.tolist()} "
          f"(equal {same_iters}), riccati_backward launches {ric} (gate 0)")
    if not (gap <= NEURAL_TOL and same_iters and ric == 0):
        raise AssertionError("neural: the nz=8 solve differs or launched")
    out["nz8_gap"] = gap

    g = torch.Generator().manual_seed(3)
    Nh, n, mm = 64, 6, 2
    A = torch.randn(8, Nh, n, n, generator=g, dtype=torch.float64) * 0.2 + \
        torch.eye(n, dtype=torch.float64)
    Bm = torch.randn(8, Nh, n, mm, generator=g, dtype=torch.float64) * 0.3
    Qh = torch.randn(8, Nh, n, n, generator=g, dtype=torch.float64) * 0.3
    Q = Qh @ Qh.mT + 0.5 * torch.eye(n, dtype=torch.float64)
    Rh = torch.randn(8, Nh, mm, mm, generator=g, dtype=torch.float64) * 0.2
    R = Rh @ Rh.mT + torch.eye(mm, dtype=torch.float64)
    QN = 2.0 * torch.eye(n, dtype=torch.float64).expand(8, n, n)
    args = [a.to(dev) for a in (A, Bm, Q, R, QN)]
    S_par = lqr.lqr_backward_parallel(*args)
    S_seq = lqr.lqr_backward_sequential(*args)
    lq_gap = float((S_par - S_seq).abs().max())
    print(f"[neural] lqr_backward_parallel vs lqr_backward_sequential, 8 "
          f"problems, N={Nh}, n={n}, float64 on the card: {lq_gap:.3e} "
          f"(gate 1e-9)")
    if not lq_gap <= 1e-9:
        raise AssertionError("neural: the parallel LQR differs")
    out["lqr_gap"] = lq_gap
    return out


def read_video(path: str, backend: str) -> np.ndarray:
    """The frames a `VideoWriterThread` wrote, (F, H, W, 3) uint8, read
    back through the sink that wrote them."""
    if backend == "npy":
        return np.load(path)
    if backend == "cv2":
        import cv2
        cap, frames = cv2.VideoCapture(path), []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
        cap.release()
        return np.stack(frames)
    import imageio.v2 as imageio
    return np.stack([np.asarray(f)[..., :3] for f in imageio.mimread(path)])


def _drawn_object(frames: np.ndarray,
                  rgb: tuple = (0x11, 0x77, 0x33)) -> np.ndarray:
    """Per frame, the centre of the pixels within 40 of `rgb` (the object's
    green #117733 unless told) in RGB, NaN where there is none: the drawn
    object (lossy containers shift colours)."""
    d = np.abs(frames.astype(int) - list(rgb)).sum(-1)
    out = []
    for mask in d < 40:
        ys, xs = np.nonzero(mask)
        out.append([xs.mean(), ys.mean()] if xs.size else [np.nan, np.nan])
    return np.asarray(out)


def phase_stream(dev: torch.device, card: str) -> dict:
    """`pmpc --stream RING --runtime STREAM_RUNTIME` through the
    dispatcher (one episode, a record a sim step into the native ring),
    gated on the native writer, a record per step, no drop and Riccati
    launches; then `watch RING --idle_timeout 1` on the file: exit 0 and
    the record count."""
    from dart_tpu_torch.io import ringlog
    from dart_tpu_torch.io.streaming import EPISODE_STREAM_DTYPE

    with tempfile.TemporaryDirectory() as tmp:
        ring = str(Path(tmp) / "ep.ring")
        rc, res, ric, reads, wall = run_cli(
            ["pmpc", "--stream", ring, "--runtime", str(STREAM_RUNTIME)])
        n_steps = int(STREAM_RUNTIME / DT)
        recs = ringlog.RingLogger.read(ring, EPISODE_STREAM_DTYPE)
        st = res["stream"]
        print(f"[stream] pmpc --stream --runtime {STREAM_RUNTIME}: rc {rc}, "
              f"native {st['native']} (is_native() {ringlog.is_native()}), "
              f"{st['records']} records pushed, {st['dropped']} dropped, "
              f"{recs.size} on disk for {n_steps} steps; {ric} Riccati "
              f"launches, {reads} host reads; {wall:.2f} s wall, the "
              f"episode {res['compile_s']} s [{card}]")
        if not (rc == 0 and st["native"] and ringlog.is_native()
                and st["records"] == n_steps == recs.size
                and st["dropped"] == 0
                and (recs["k"] == np.arange(n_steps)).all()):
            raise AssertionError("stream: the ring is wrong")
        if ric == 0:
            raise AssertionError("stream: no Riccati launch")
        rc_w, text, _, _, wall_w = run_cli_text(
            ["watch", ring, "--idle_timeout", "1"])
        last = text.splitlines()[-1] if text else ""
        print(f"[stream] watch --idle_timeout 1: rc {rc_w}, {wall_w:.2f} s, "
              f"last line {last!r}")
        if rc_w != 0 or f"after {n_steps} records" not in last:
            raise AssertionError("stream: watch failed")
    return {"records": st["records"], "launches": ric, "wall": wall}


def check_fs_video(rc: int, res: dict, ric: int, wall: float,
                   card: str) -> dict:
    """Gate a `pmpc --full_stack --video --runtime FULL_STACK_RUNTIME` run
    (its JSON `res`, while its file exists): a frame every 20 world steps
    written to whichever container the writer chain reached and read back,
    frames not blank, the object and both arms drawn in every frame, the
    arms' drawn positions moving, Riccati launches. The object rests
    through the first FS_CLI_WARMUP of the run's 260 world steps, so its
    drawn position is not asked to move here (the preview asks it)."""
    v = res["video"]
    frames = read_video(v["path"], v["backend"])
    want = -(-int(FULL_STACK_RUNTIME / DT) // 20)
    spread = [len(np.unique(f.reshape(-1, 3), axis=0)) for f in frames]
    obj = _drawn_object(frames)
    arms = [_drawn_object(frames, rgb) for rgb in ((0x33, 0x66, 0xcc),
                                                   (0xcc, 0x77, 0x22))]
    drawn = all(np.isfinite(c).all() for c in (obj, *arms))
    arm_moved = max(float(np.nanmax(np.hypot(*(c - c[0]).T)))
                    for c in arms)
    obj_moved = float(np.nanmax(np.hypot(*(obj - obj[0]).T)))
    print(f"[video] pmpc --full_stack --video --runtime {FULL_STACK_RUNTIME}:"
          f" rc {rc}, {v['frames']} frames through {v['backend']} to "
          f"{Path(v['path']).name}, {len(frames)} read back (want {want}), "
          f"colours per frame {min(spread)}-{max(spread)}, object and arms "
          f"drawn in every frame {drawn}, the arms' drawn centres moved up "
          f"to {arm_moved:.2f} px (gate > 1), the object's {obj_moved:.2f} "
          f"px; {ric} Riccati launches; {wall:.1f} s wall for 4 episodes "
          f"[{card}]")
    if not (rc == 0 and v["frames"] == want == len(frames)
            and min(spread) > 3 and drawn and arm_moved > 1.0 and ric > 0):
        raise AssertionError("video: the full-stack video is wrong")
    return {"frames": v["frames"], "backend": v["backend"], "wall": wall,
            "launches": ric, "arm_moved_px": arm_moved}


def phase_video(dev: torch.device, card: str,
                fs_video: dict | None = None) -> dict:
    """`pmpc --full_stack --video --runtime FULL_STACK_RUNTIME` (the
    full-stack phase's float32 command, `fs_video`, when it ran in this
    call; else run here) and `preview --object PREVIEW_OBJECT --seconds
    PREVIEW_SECONDS` through the dispatcher, each gated on the frames
    written (a frame every 20 steps, to whichever container the writer
    chain reached, read back) and frames not blank, the preview on the
    object's drawn position moving."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        if fs_video is None:
            rc, res, ric, _, wall = run_cli(
                ["pmpc", "--full_stack", "--video", str(Path(tmp) / "fs.mp4"),
                 "--runtime", str(FULL_STACK_RUNTIME)])
            fs_video = check_fs_video(rc, res, ric, wall, card)
        out["full_stack"] = fs_video

        path = str(Path(tmp) / "preview.mp4")
        rc, res, _, _, wall = run_cli(
            ["preview", "--object", PREVIEW_OBJECT, "--seconds",
             str(PREVIEW_SECONDS), "--out", path])
        frames = read_video(res["written"], res["backend"])
        want = -(-int(PREVIEW_SECONDS / DT) // 20)
        obj = _drawn_object(frames)
        moved = float(np.hypot(*(obj[-1] - obj[0])))
        spread = [len(np.unique(f.reshape(-1, 3), axis=0)) for f in frames]
        print(f"[video] preview --object {PREVIEW_OBJECT} --seconds "
              f"{PREVIEW_SECONDS}: rc {rc}, {res['frames']} frames through "
              f"{res['backend']}, {len(frames)} read back (want {want}), "
              f"colours per frame {min(spread)}-{max(spread)}, the drawn "
              f"object moved {moved:.1f} px (final p {res['final_p']}); "
              f"{wall:.1f} s wall [{card}]")
        if not (rc == 0 and res["frames"] == want == len(frames)
                and min(spread) > 3 and moved > 2.0):
            raise AssertionError("video: the preview is wrong")
        out["preview"] = {"frames": res["frames"], "moved_px": moved,
                          "wall": wall}
    return out


# ---------------------------------------------------------------------------
# The multi-device layer: ranks as processes on the one card
# ---------------------------------------------------------------------------

SCRIPT = Path(__file__).resolve()
MD_RANKS = 2
MD_LANES = 128             # run_sweep_batched's lane multiple
MD_AGG_RTOL = 1e-6
MD_TRAIN_ROLLOUT = 2       # the dryrun's 64, cut for the script's time
MD_TRAIN_STEPS = 2
MD_GRAD_RTOL = 1e-5        # __graft_entry__.py:152-157's gradient gate
MD_TIMEOUT = 300           # seconds a rank's process, or torchrun, may take


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _md_train_setup(rank: int, dev: torch.device):
    """`__graft_entry__.dryrun_multichip`'s controller, env and PPO pass
    (its rollout cut to MD_TRAIN_ROLLOUT) with one env a rank, float32: the
    policy and the train generator from seed 0 on every rank, the env from
    seed 1 + rank. Returns (ctlr, env_cfg, ppo_cfg, TrainState, env)."""
    from dart_tpu_torch.adapt import lmpc_trainer as trainer
    from dart_tpu_torch.adapt import ppo as ppo_mod
    from dart_tpu_torch.control import mpc as mpc_mod

    ctlr = mpc_mod.LMPC(N=4, dt=0.02, cfg=mpc_mod.ilqr.ILQRConfig(
        max_iters=2, al_iters=1, n_alphas=4))
    env_cfg = trainer.EnvConfig(dt=0.02, max_episode_steps=32)
    ppo_cfg = ppo_mod.PPOConfig(epochs=1, minibatch_size=MD_TRAIN_ROLLOUT)
    ts = trainer.init_train_state(torch.Generator().manual_seed(0), ppo_cfg,
                                  dev)
    env = trainer.env_init(ctlr, env_cfg, 1, torch.float32, dev,
                           gen=torch.Generator().manual_seed(1 + rank))
    return ctlr, env_cfg, ppo_cfg, ts, env


def md_rank(rank: int, addr: str, out: Path, device: str) -> int:
    """One of the multidevice phase's gloo ranks, all on `device`: (a) its
    block of the sharded PMPC batch sweep at B rows, then (c) MD_TRAIN_STEPS
    data-parallel LMPC train steps; writes out/r{rank}.pt."""
    from dart_tpu_torch.adapt import lmpc_trainer as trainer
    from dart_tpu_torch.ops.kernels import pmpc_solve as kps
    from dart_tpu_torch.ops.kernels.riccati import riccati_backward
    from dart_tpu_torch.parallel import mesh as mesh_mod
    from dart_tpu_torch.parallel import sweep as sweep_mod
    from dart_tpu_torch.rollout import evaluate

    dev = torch.device(device)
    mesh_mod.init_distributed(addr, MD_RANKS, rank, backend="gloo",
                              device=dev)
    mesh = mesh_mod.make_mesh(MD_RANKS, device=dev)
    sc = eval_scenarios(dev)
    ev = evaluate.make_pmpc_batch_evaluator()
    kps.pmpc_solve.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, agg = sweep_mod.run_sweep_batched(ev, sc, mesh, MD_LANES)
    torch.cuda.synchronize()
    res_out = {"sweep_s": time.perf_counter() - t0,
               "pmpc_launches": kps.pmpc_solve.launches,
               "metrics": {k: v.cpu() for k, v in
                           res.metrics._asdict().items()},
               "final_p": res.final_p.cpu(),
               "agg": {k: v.cpu() for k, v in agg._asdict().items()}}

    ctlr, env_cfg, ppo_cfg, ts, env = _md_train_setup(rank, dev)
    step = trainer.make_train_step(ctlr, env_cfg, ppo_cfg, MD_TRAIN_ROLLOUT,
                                   group=mesh.group)
    rewards, finite = [], []
    riccati_backward.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(MD_TRAIN_STEPS):
        ts, env, stats = step(ts, env)
        rewards.append(float(stats["mean_reward"]))
        finite.append(all(bool(torch.isfinite(p).all())
                          for p in ts.model.parameters()))
        if k == 0:
            res_out["grads"] = [p.grad.cpu() for p in ts.model.parameters()]
    torch.cuda.synchronize()
    res_out.update(train_s=time.perf_counter() - t0,
                   riccati_launches=riccati_backward.launches,
                   rewards=rewards, finite=finite,
                   params={k: v.cpu() for k, v in
                           ts.model.state_dict().items()})
    torch.save(res_out, out / f"r{rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


def md_cli_rank(out: Path, argv: list[str]) -> int:
    """A torchrun rank of a command through the dispatcher, as `python -m
    dart_tpu_torch.cli` runs it; writes its exit code and Riccati
    launches to out/cli_r{RANK}.json."""
    from dart_tpu_torch.cli.__main__ import main as dispatch
    from dart_tpu_torch.ops.kernels.riccati import riccati_backward

    riccati_backward.launches = 0
    rc = dispatch(argv)
    (out / f"cli_r{os.environ['RANK']}.json").write_text(json.dumps(
        {"rc": rc, "launches": riccati_backward.launches}))
    return rc


def _md_wait(procs: list, label: str) -> list[str]:
    """Wait for the processes, each bounded by MD_TIMEOUT, and kill what is
    left on the way out. Returns their standard outputs; a nonzero exit
    raises."""
    try:
        outs = [p.communicate(timeout=MD_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(out[-2000:], err[-4000:])
            raise AssertionError(f"{label}: process {i} exited "
                                 f"{p.returncode}")
    return [out for out, _ in outs]


def _md_references(dev: torch.device, argv: list[str]) -> dict:
    """This process's share of the phase, run while the ranks and torchrun
    run: (a) the evaluator on each rank's block alone and on the B lanes
    as one call, (c) each rank's first train step alone on its draws
    (`rank_generator`'s seed and the rank), its gradient kept, (b) the
    sweep command without torchrun."""
    from dart_tpu_torch.adapt import lmpc_trainer as trainer
    from dart_tpu_torch.io.scenes import ScenarioBatch
    from dart_tpu_torch.parallel import sweep as sweep_mod
    from dart_tpu_torch.rollout import evaluate

    sc = eval_scenarios(dev)
    ev = evaluate.make_pmpc_batch_evaluator()

    def timed(rows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sweep_mod.run_sweep_batched(ev, rows, None, MD_LANES)[0]
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # B is a multiple of MD_RANKS * MD_LANES: each rank's block is real rows.
    per = B // MD_RANKS
    blocks, block_s = zip(*(timed(ScenarioBatch(
        *(x[r * per:(r + 1) * per] for x in sc))) for r in range(MD_RANKS)))
    whole, whole_s = timed(sc)

    grads = []
    for r in range(MD_RANKS):
        ctlr, env_cfg, ppo_cfg, ts, env = _md_train_setup(r, dev)
        gen = trainer.rank_generator(ts.gen, r)
        draws = [trainer.draw_step(gen, 1, torch.float32, dev)
                 for _ in range(MD_TRAIN_ROLLOUT)]
        step = trainer.make_train_step(ctlr, env_cfg, ppo_cfg,
                                       MD_TRAIN_ROLLOUT)
        step(ts, env, trainer.TrainDraws(rollout=draws))
        grads.append([p.grad.cpu() for p in ts.model.parameters()])
    return {"metrics": {k: torch.cat([getattr(b.metrics, k)
                                      for b in blocks]).cpu()
                        for k in blocks[0].metrics._fields},
            "final_p": torch.cat([b.final_p for b in blocks]).cpu(),
            "block_s": block_s, "whole_s": whole_s,
            "whole_converged": whole.metrics.converged.cpu(),
            "grads": [sum(g) / MD_RANKS for g in zip(*grads)],
            "cli": run_cli(argv)}


def _md_sweep(ranks: list[dict], ref: dict, card: str) -> dict:
    """(a) gates: every rank's rows the same, and equal bit for bit to the
    one-rank calls on the ranks' blocks; the aggregate the masked formula
    over them; pmpc_solve launched on each rank."""
    want = ref["metrics"]
    flips = int((ref["whole_converged"] != want["converged"]).sum())
    for r, got in enumerate(ranks):
        same = all(torch.equal(got["metrics"][k], v) for k, v in want.items())
        if not (same and torch.equal(got["final_p"], ref["final_p"])):
            raise AssertionError(f"multidevice: rank {r}'s rows are not the "
                                 "one-rank calls' on the two blocks")
    conv = want["converged"]
    n_conv = float(conv.sum())
    formula = {"n": float(B), "n_converged": n_conv,
               "mean_sse": float(want["steady_state_error"].double().mean()),
               "mean_effort": float(want["control_effort"].double().mean()),
               "mean_conv_time": float(want["convergence_time"][conv]
                                       .double().sum()) / max(n_conv, 1.0)}
    agg_err = max(abs(float(ranks[0]["agg"][k]) - v) / max(abs(v), 1e-30)
                  for k, v in formula.items())
    success = float((want["steady_state_error"] < 0.01).float().mean())
    rank_s = [round(g["sweep_s"], 3) for g in ranks]
    block_s = [round(t, 3) for t in ref["block_s"]]
    print(f"[multidevice] (a) run_sweep_batched(make_pmpc_batch_evaluator(),"
          f" B={B}, {EVAL_STEPS} steps, float32) over {MD_RANKS} gloo ranks "
          f"on one card: each rank's sweep {rank_s} s, pmpc_solve "
          f"launches {[g['pmpc_launches'] for g in ranks]}; "
          f"rows bit for bit the one-rank calls' on each block; aggregate "
          f"vs the masked formula {agg_err:.3e} relative (gate "
          f"{MD_AGG_RTOL}); success@1cm {success:.4f}; lanes whose "
          f"`converged` differs from one {B}-lane call: {flips}; in this "
          f"process, one rank's block alone {block_s} s, the {B} lanes as "
          f"one call {ref['whole_s']:.3f} s [{card}]")
    if not agg_err <= MD_AGG_RTOL:
        raise AssertionError(f"multidevice: aggregate off by {agg_err}")
    if min(g["pmpc_launches"] for g in ranks) == 0:
        raise AssertionError("multidevice: a rank launched no pmpc_solve")
    return {"sweep_s": [g["sweep_s"] for g in ranks],
            "block_s": ref["block_s"], "whole_s": ref["whole_s"],
            "agg_err": agg_err, "success": success, "flips": flips,
            "launches": [g["pmpc_launches"] for g in ranks]}


def _md_train(ranks: list[dict], ref: dict, card: str) -> dict:
    """(c) gates: finite rewards and parameters after each step, the ranks'
    parameters equal bit for bit after the last, step 1's averaged
    gradient the sequential emulation's (each rank's train step run alone
    on its draws, the gradients averaged) to MD_GRAD_RTOL, and Riccati
    launches on each rank."""
    err = max(float(((a - b).abs() / (1.0 + a.abs())).max())
              for a, b in zip(ranks[0]["grads"], ref["grads"]))
    same = all(torch.equal(v, ranks[1]["params"][k])
               for k, v in ranks[0]["params"].items())
    rank_s = [round(g["train_s"], 3) for g in ranks]
    print(f"[multidevice] (c) {MD_TRAIN_STEPS} data-parallel LMPC train "
          f"steps (N=4, one env x {MD_TRAIN_ROLLOUT} steps a rank, float32) "
          f"over {MD_RANKS} gloo ranks: {rank_s} s, mean rewards "
          f"{[g['rewards'] for g in ranks]}, riccati "
          f"launches {[g['riccati_launches'] for g in ranks]}; step 1's "
          f"averaged gradient vs the sequential emulation {err:.3e} (gate "
          f"{MD_GRAD_RTOL}); parameters equal across ranks: {same} [{card}]")
    for r, g in enumerate(ranks):
        if not (all(g["finite"]) and all(np.isfinite(g["rewards"]))):
            raise AssertionError(f"multidevice: rank {r} went non-finite")
        if g["riccati_launches"] == 0:
            raise AssertionError(f"multidevice: rank {r} launched no "
                                 "riccati_backward")
    if not same:
        raise AssertionError("multidevice: the ranks' parameters differ")
    if not err <= MD_GRAD_RTOL:
        raise AssertionError(f"multidevice: gradient off by {err}")
    return {"train_s": [g["train_s"] for g in ranks], "grad_err": err,
            "launches": [g["riccati_launches"] for g in ranks]}


def _md_cli(text: str, rank0: dict, ref: dict, card: str) -> dict:
    """(b) gates: torchrun's rank exits 0 and prints one JSON with
    `devices` 1 and 18 rows equal to the same command's without torchrun,
    after Riccati launches."""
    got = json.loads(text)
    rc, want, ric, _, plain_wall = ref["cli"]
    print(f"[multidevice] (b) torchrun --nproc_per_node=1 ... cli sweep "
          f"--runtime {SWEEP_INSTANCE_RUNTIME}: rc {rank0['rc']}, devices "
          f"{got['summary']['devices']}, {len(got['scenarios'])} rows, "
          f"{rank0['launches']} riccati launches; without torchrun rc {rc}, "
          f"{ric} launches, {plain_wall:.3f} s [{card}]")
    if rank0["rc"] != 0 or rc != 0:
        raise AssertionError("multidevice: the sweep command failed")
    if got["summary"]["devices"] != 1 or len(got["scenarios"]) != 18:
        raise AssertionError("multidevice: torchrun's sweep JSON is wrong")
    if got != want:
        raise AssertionError("multidevice: torchrun's sweep differs from "
                             "the command's without torchrun")
    if rank0["launches"] == 0:
        raise AssertionError("multidevice: no riccati_backward launch "
                             "under torchrun")
    return {"launches": rank0["launches"]}


def phase_multidevice(dev: torch.device, card: str) -> dict:
    """The multi-device layer on the one card: (a) `run_sweep_batched` of
    `make_pmpc_batch_evaluator()` over two gloo ranks at B rows, EVAL_STEPS
    steps, float32, then (c) two data-parallel LMPC train steps, both ranks
    on `dev`; (b) the sweep command under torchrun with NCCL at world size
    1. The rank processes and torchrun run side by side with this
    process's reference work (`_md_references`), so every time the phase
    prints is taken under that load."""
    argv = ["sweep", "--runtime", str(SWEEP_INSTANCE_RUNTIME)]
    with tempfile.TemporaryDirectory() as tmp:
        addr = f"127.0.0.1:{_free_port()}"
        cmds = [[sys.executable, str(SCRIPT), "rank", str(r), addr, tmp,
                 str(dev)] for r in range(MD_RANKS)]
        cmds.append([sys.executable, "-m", "torch.distributed.run",
                     "--standalone", "--nproc_per_node=1", str(SCRIPT),
                     "rank-cli", tmp, *argv])
        t0 = time.perf_counter()
        procs = [subprocess.Popen(c, cwd=SCRIPT.parent,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        try:
            ref = _md_references(dev, argv)
        finally:
            outs = _md_wait(procs, "multidevice")
        wall = time.perf_counter() - t0
        ranks = [torch.load(Path(tmp) / f"r{r}.pt", weights_only=True)
                 for r in range(MD_RANKS)]
        rank0 = json.loads((Path(tmp) / "cli_r0.json").read_text())
    print(f"[multidevice] two ranks, torchrun and this process's share, "
          f"start to the last exit: {wall:.3f} s [{card}]")
    return {"wall": wall, "sweep": _md_sweep(ranks, ref, card),
            "train": _md_train(ranks, ref, card),
            "cli": _md_cli(outs[-1], rank0, ref, card)}


PHASES = ("pmpc", "riccati", "rmpc", "main", "fallback", "rmpc-main",
          "rescue", "lmpc", "lmpc-main", "lmpc-fallback", "pmpc-eval",
          "rmpc-eval", "sweep", "solve", "pmpc-cli", "rmpc-cli",
          "sweep-instance", "ppo", "lmpc-train", "lmpc-eval", "arm",
          "full-stack", "fullstack-train", "mppi-eval", "neural", "stream",
          "video", "multidevice", "times")
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
    elif ph == "solve":
        res["solve"] = phase_solve(dev, card)
    elif ph in ("pmpc-cli", "rmpc-cli"):
        res[ph] = phase_cli(ph[:4], card)
    elif ph == "sweep-instance":
        res["sweep_instance"] = phase_sweep_instance(card)
    elif ph == "ppo":
        res["ppo"] = phase_ppo(dev, card)
    elif ph == "lmpc-train":
        res["lmpc_train"] = phase_lmpc_train(dev, card)
    elif ph == "lmpc-eval":
        res["lmpc_eval"] = phase_lmpc_eval(dev, card)
    elif ph == "arm":
        res["arm"] = phase_arm(dev, card)
    elif ph == "full-stack":
        res["full_stack"] = phase_full_stack(dev, card)
    elif ph == "fullstack-train":
        res["fullstack_train"] = phase_fullstack_train(dev, card)
    elif ph == "mppi-eval":
        res["mppi_eval"] = phase_mppi_eval(dev, card)
    elif ph == "neural":
        res["neural"] = phase_neural(dev, card)
    elif ph == "stream":
        res["stream"] = phase_stream(dev, card)
    elif ph == "video":
        res["video"] = phase_video(dev, card,
                                   res.get("full_stack", {}).get("video"))
    elif ph == "multidevice":
        res["multidevice"] = phase_multidevice(dev, card)
    elif ph == "times":
        res["pmpc_times"] = phase_times(dev, card)
        res["times"] = phase_kernel_times(dev, card)
    elif ph == "profile":
        phase_profile(dev, card)
    elif ph == "scan":
        phase_scan(dev, card)


# The default run's phases, in worker processes that share the card: each
# group's phases run in order in one process, the groups side by side. One
# after another the phases took 900-1000 s on an H100 (PERF.md section 5),
# too near the 1200 s limit; the groups are balanced on those seconds.
# `video` reads `full-stack`'s result, so they share a group. `times` runs
# alone after the workers, on an idle card. Named phases run one after
# another in this process, as before.
WORKER_GROUPS = (
    ("pmpc", "riccati", "rmpc", "main", "fallback", "rmpc-main", "rescue",
     "lmpc", "lmpc-main", "lmpc-fallback", "pmpc-eval"),
    ("sweep", "lmpc-eval", "ppo", "arm"),
    ("full-stack", "video", "stream", "multidevice"),
    ("solve", "neural", "rmpc-cli"),
    ("rmpc-eval", "lmpc-train", "mppi-eval", "fullstack-train", "pmpc-cli",
     "sweep-instance"),
)
WORKER_TIMEOUT = 900       # seconds for a group's process
# What the kernels' JSON line reads from the phases' results.
RECORD_KEYS = ("pmpc_launches", "pmpc_err", "ric_err", "rmpc_err",
               "lmpc_err", "fallback", "rmpc_main", "lmpc_main")


def run_phases(phases: list[str], dev: torch.device, card: str
               ) -> tuple[dict, list[str]]:
    """Each phase in turn, its failure printed and noted, not raised.
    Returns (results, the phases that failed)."""
    res, failed = {}, []
    for ph in phases:
        t0 = time.perf_counter()
        try:
            run_phase(ph, dev, card, res)
        except Exception:
            traceback.print_exc()
            failed.append(ph)
        print(f"[phase] {ph}: {time.perf_counter() - t0:.1f} s", flush=True)
    return res, failed


def worker(out: Path, phases: list[str]) -> int:
    """One group's process: its phases, then the part of their results the
    kernels' JSON line reads, and the failed phases, written to `out`."""
    card = require_card()
    res, failed = run_phases(phases, torch.device("cuda", 0), card)
    record = {k: res[k] for k in RECORD_KEYS if k in res}
    for k in ("fallback", "rmpc_main", "lmpc_main"):
        if k in record:
            record[k] = {"launches": int(record[k]["launches"])}
    out.write_text(json.dumps({"res": record, "failed": failed}))
    return 1 if failed else 0


def run_workers(groups: tuple) -> tuple[dict, list[str]]:
    """Start one process a group, all at once, each bounded by
    WORKER_TIMEOUT and killed on the way out if it is still running; print
    their outputs group by group. CPU threads are shared out among them.
    Returns (the merged results, the failed phases)."""
    cores = len(os.sched_getaffinity(0))
    env = {**os.environ,
           "OMP_NUM_THREADS": str(max(2, cores // len(groups)))}
    res, failed = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        procs = []
        try:
            for i, group in enumerate(groups):
                with open(tmp / f"w{i}.out", "w") as so, \
                        open(tmp / f"w{i}.err", "w") as se:
                    procs.append(subprocess.Popen(
                        [sys.executable, str(SCRIPT), "worker",
                         str(tmp / f"w{i}.json"), *group],
                        cwd=SCRIPT.parent, env=env, stdout=so, stderr=se))
            deadline = time.perf_counter() + WORKER_TIMEOUT
            for p in procs:
                try:
                    p.wait(timeout=max(1.0, deadline - time.perf_counter()))
                except subprocess.TimeoutExpired:
                    pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for i, (group, p) in enumerate(zip(groups, procs)):
            print(f"[worker] {i}: {' '.join(group)}: exit {p.returncode}")
            print((tmp / f"w{i}.out").read_text(), end="", flush=True)
            sys.stderr.write((tmp / f"w{i}.err").read_text())
            result = tmp / f"w{i}.json"
            if not result.exists():
                failed.append(f"worker {i} ({' '.join(group)}): exit "
                              f"{p.returncode}, no result")
                continue
            got = json.loads(result.read_text())
            res.update(got["res"])
            failed += got["failed"]
    return res, failed


def main(argv: list[str]) -> int:
    # The multidevice phase's own processes, and the default run's groups.
    if argv[:1] == ["rank"]:
        return md_rank(int(argv[1]), argv[2], Path(argv[3]), argv[4])
    if argv[:1] == ["rank-cli"]:
        return md_cli_rank(Path(argv[1]), argv[2:])
    if argv[:1] == ["worker"]:
        return worker(Path(argv[1]), argv[2:])
    phases = argv or list(PHASES)
    unknown = set(phases) - set(PHASES) - set(EXTRA_PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}; "
                         f"choose from {PHASES + EXTRA_PHASES}")
    card = phase_device()
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    phase_build()
    if argv:
        res, failed = run_phases(phases, dev, card)
    else:
        res, failed = run_workers(WORKER_GROUPS)
        t0 = time.perf_counter()
        print(f"[phase] workers: {t0 - t_start:.1f} s", flush=True)
        more, failed_times = run_phases(["times"], dev, card)
        res.update(more)
        failed += failed_times
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
