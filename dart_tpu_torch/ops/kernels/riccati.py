"""Batched box-DDP Riccati backward pass in one launch (port of
`dart_tpu.ops.pallas.riccati.riccati_backward_pallas`).

Per stage: the Q expansion (Qxx from the unregularised Vxx, Qux/Quu from
Vxx + reg I, Quu symmetrised with a 1e-9 jitter), the exact 2x2 box QP
over the control step, the feedback gains on the free set, and the
symmetric value update. nu == 2 (the tray tilt); nz is 6 (PMPC, RMPC's
augmented state) or 10 (LMPC's augmented state).

`_backward_lanes`, the kernel body's plain version, is also the port's
generic backward pass (JAX's `ilqr._backward`) for the shapes the kernel
has no instance for: any nz, and for nu != 2 the projected-Newton box QP
(`ops.boxqp.boxqp_pn`) with the gains from a batched solve.

`riccati_backward` keeps `riccati_backward_pallas`'s batch-last layout:
A (N,nz,nz,B), B (N,nz,2,B), lx (N,nz,B), lu (N,2,B), lxx (N,nz,nz,B),
lux (N,2,nz,B), luu (N,2,2,B), gx (nz,B), gxx (nz,nz,B), V (N,2,B);
u_lo/u_hi two bounds each; reg a scalar or (B,). Returns D (N,2,B) and
K (N,2,nz,B). On CUDA tensors it launches `csrc/riccati.cu` (a lane per
group of 4 threads, each stage's inputs copied into shared memory stages
ahead); on CPU tensors it runs `riccati_backward_reference`, the plain
PyTorch version of `_backward_kernel`.
"""

from __future__ import annotations

import ctypes

import torch

from dart_tpu_torch.ops.boxqp import boxqp_pn
from dart_tpu_torch.ops.kernels import _build
from dart_tpu_torch.ops.kernels.lanes import (_add_diag, _boxqp2_lanes,
                                              _gains_lanes, _mm, _mmc, _mT,
                                              _mv)

NZ_INSTANCES = (6, 10)


def _boxqp_pn_lanes(Quu, Qu, lo, hi, Qux):
    """A stage's box QP and gains for any nu, lane layout in and out:
    projected Newton, then H K = -(Qux on the free rows) with H = free Quu
    free + diag(1 - free), as JAX's `ilqr._backward`. Returns d (nu,L),
    K (nu,nz,L)."""
    Q, g, lo_, hi_, X = (torch.movedim(t, -1, 0)
                         for t in (Quu, Qu, lo, hi, Qux))
    d, free = boxqp_pn(Q, g, lo_, hi_)
    eye = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)
    H = Q * free[:, :, None] * free[:, None, :] + eye * (1.0 - free)[:, None]
    K = -torch.linalg.solve(H, X * free[:, :, None])
    return torch.movedim(d, 0, -1), torch.movedim(K, 0, -1)


def _backward_lanes(A, Bm, lx, lu, lxx, lux, luu, gx, gxx, V, lo, hi, reg):
    """Plain version of the kernel body `_backward_kernel`, on (..., L)
    lanes, for any nz and nu; lo/hi (nu,L), reg (L,). nu == 2 takes the
    kernel's exact box QP and closed-form gains, any other nu
    `_boxqp_pn_lanes`. Returns D (N,nu,L), K (N,nu,nz,L)."""
    N, nu = A.shape[0], V.shape[1]
    Vx, Vxx = gx, gxx
    Ds, Ks = [None] * N, [None] * N
    for k in range(N - 1, -1, -1):
        A_k, B_k = A[k], Bm[k]
        Qx = lx[k] + _mv(_mT(A_k), Vx)
        Qu = lu[k] + _mv(_mT(B_k), Vx)
        Vxx_reg = _add_diag(Vxx, reg)
        Qxx = lxx[k] + _mm(_mT(A_k), _mm(Vxx, A_k))
        Qux = lux[k] + _mm(_mT(B_k), _mm(Vxx_reg, A_k))
        Quu = luu[k] + _mm(_mT(B_k), _mm(Vxx_reg, B_k))
        Quu = _add_diag(0.5 * (Quu + _mT(Quu)), 1e-9)

        if nu == 2:
            d, free = _boxqp2_lanes(Quu, Qu, lo - V[k], hi - V[k])
            # Every column of Qux at once (the same operations per column).
            (gains,) = _gains_lanes(Quu, free, [(Qux[0], Qux[1])])
            K = torch.stack(gains)                            # (2, nz, L)
        else:
            d, K = _boxqp_pn_lanes(Quu, Qu, lo - V[k], hi - V[k], Qux)

        Quu_d = _mv(Quu, d)
        Vx = Qx + _mv(_mT(K), Quu_d) + _mv(_mT(K), Qu) + _mv(_mT(Qux), d)
        KT_Quu = _mm(_mT(K), Quu)
        Vxx = (Qxx + _mm(KT_Quu, K) + _mm(_mT(K), Qux)
               + _mm(_mT(Qux), K))
        Vxx = 0.5 * (Vxx + _mT(Vxx))
        Ds[k], Ks[k] = d, K
    return torch.stack(Ds), torch.stack(Ks)


def _check(A, B, lx, lu, lxx, lux, luu, gx, gxx, V):
    if A.dim() != 4:
        raise ValueError(f"A must be (N, nz, nz, B), got {tuple(A.shape)}")
    N, nz, _, Bt = A.shape
    want = {"A": (N, nz, nz, Bt), "B": (N, nz, 2, Bt), "lx": (N, nz, Bt),
            "lu": (N, 2, Bt), "lxx": (N, nz, nz, Bt), "lux": (N, 2, nz, Bt),
            "luu": (N, 2, 2, Bt), "gx": (nz, Bt), "gxx": (nz, nz, Bt),
            "V": (N, 2, Bt)}
    got = {"A": A, "B": B, "lx": lx, "lu": lu, "lxx": lxx, "lux": lux,
           "luu": luu, "gx": gx, "gxx": gxx, "V": V}
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"riccati_backward takes float32 or float64, "
                        f"got {A.dtype}")
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, "
                             f"got {tuple(t.shape)}")
        if t.dtype != A.dtype:
            raise TypeError(f"{name} is {t.dtype}, A is {A.dtype}")
        if t.device != A.device:
            raise ValueError(f"{name} is on {t.device}, A on {A.device}")
    return N, nz, Bt


def _bounds(u_lo, u_hi) -> tuple[float, float, float, float]:
    lo = [float(x) for x in u_lo]
    hi = [float(x) for x in u_hi]
    if len(lo) != 2 or len(hi) != 2:
        raise ValueError("u_lo and u_hi must hold two bounds each")
    return lo[0], lo[1], hi[0], hi[1]


def _reg_lanes(reg, Bt: int, like: torch.Tensor) -> torch.Tensor:
    """reg as a contiguous (B,) lane vector of A's dtype and device."""
    r = torch.as_tensor(reg, dtype=like.dtype, device=like.device)
    if r.dim() == 0:
        return r.expand(Bt).contiguous()
    if tuple(r.shape) != (Bt,):
        raise ValueError(f"reg must be a scalar or ({Bt},), "
                         f"got {tuple(r.shape)}")
    return r.contiguous()


def riccati_backward_reference(A, B, lx, lu, lxx, lux, luu, gx, gxx, V,
                               u_lo, u_hi, reg):
    """Plain PyTorch version of `riccati_backward`, on any device."""
    _, _, Bt = _check(A, B, lx, lu, lxx, lux, luu, gx, gxx, V)
    lo0, lo1, hi0, hi1 = _bounds(u_lo, u_hi)
    lo = torch.tensor([lo0, lo1], dtype=A.dtype, device=A.device)[:, None]
    hi = torch.tensor([hi0, hi1], dtype=A.dtype, device=A.device)[:, None]
    return _backward_lanes(A, B, lx, lu, lxx, lux, luu, gx, gxx, V,
                           lo.expand(2, Bt), hi.expand(2, Bt),
                           _reg_lanes(reg, Bt, A))


def riccati_backward(A, B, lx, lu, lxx, lux, luu, gx, gxx, V, u_lo, u_hi,
                     reg):
    """Batched backward pass, batch-last. Returns (D (N,2,B), K (N,2,nz,B)).

    CPU tensors run the plain version. CUDA tensors launch the kernel and
    add one to `riccati_backward.launches`; an nz without an instance
    (`NZ_INSTANCES`) or a failed launch raises.
    """
    if A.device.type == "cpu":
        return riccati_backward_reference(A, B, lx, lu, lxx, lux, luu, gx,
                                          gxx, V, u_lo, u_hi, reg)
    N, nz, Bt = _check(A, B, lx, lu, lxx, lux, luu, gx, gxx, V)
    if A.device.type != "cuda":
        raise ValueError(f"riccati_backward runs on cpu or cuda, "
                         f"not {A.device}")
    bounds = _bounds(u_lo, u_hi)
    ins = [t.contiguous() for t in (A, B, lx, lu, lxx, lux, luu, gx, gxx, V)]
    ins.append(_reg_lanes(reg, Bt, A))
    D = torch.empty((N, 2, Bt), dtype=A.dtype, device=A.device)
    K = torch.empty((N, 2, nz, Bt), dtype=A.dtype, device=A.device)
    lib = _build.library()
    fn = lib.riccati_f32 if A.dtype == torch.float32 else lib.riccati_f64
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):
        err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (*ins, D, K)),
                 Bt, N, nz, *bounds, ctypes.c_void_p(stream))
    if err == _build.BAD_SHAPE:
        raise NotImplementedError(
            f"the CUDA kernel has no instance for nz={nz} (it has "
            f"{NZ_INSTANCES}): add one to launch() in csrc/riccati.cu")
    if err != 0:
        raise RuntimeError(f"riccati_backward kernel launch failed: "
                           f"{_build.error_string(err)} (code {err})")
    riccati_backward.launches += 1
    return D, K


riccati_backward.launches = 0


def launch_geometry(nz: int, dtype: torch.dtype) -> dict:
    """Launch geometry of the CUDA instance for state size nz and `dtype`
    (`_build.launch_geometry`). Needs the built library and a card."""
    return _build.launch_geometry("riccati", nz,
                                  torch.empty((), dtype=dtype).element_size())


def _stage_counts(N: int, A_nz, B_nz) -> int:
    """FLOPs of N backward stages over the structural non-zeros of A (nz,
    nz) and B (nz, 2) (masks; dense where the caller's data is dense), with
    each value computed once: Vxx_reg A = Vxx A + reg A and Vxx_reg B =
    Vxx B + reg B reuse the unregularised products, and the symmetric
    results (Qxx, Quu, the new Vxx) count their upper triangle. lx, lu,
    lxx, lux, luu, gx and gxx count dense; Vxx's mask follows the
    recursion."""
    nz = A_nz.shape[0]
    up = torch.triu(torch.ones(nz, nz, dtype=torch.bool))
    up2 = torch.triu(torch.ones(2, 2, dtype=torch.bool))
    Vxx = torch.ones(nz, nz, dtype=torch.bool)
    col = torch.ones(nz, 1, dtype=torch.bool)
    flops = 0
    for _ in range(N):
        n = _mmc(A_nz.T, col)[1] + nz                                # Qx
        n += _mmc(B_nz.T, col)[1] + 2                                # Qu
        W, c = _mmc(Vxx, A_nz)
        n += c
        Qxx, c = _mmc(A_nz.T, W, out=up)
        n += c + int(up.sum())                                       # + lxx
        n += 2 * int(A_nz.sum())                                     # + reg A
        Qux, c = _mmc(B_nz.T, W | A_nz)
        n += c + 2 * nz                                              # + lux
        WB, c = _mmc(Vxx, B_nz)
        n += c + 2 * int(B_nz.sum())                                 # + reg B
        n += _mmc(B_nz.T, WB | B_nz, out=up2)[1] + 3 + 4   # + luu, sym, jitter
        # The box QP's nine candidates (~150) and the gains on the free set:
        # h00, h01, h11 and det (9), per column b * f and the 2x2 solve (7).
        n += 150 + 9 + 7 * int(Qux.any(0).sum())
        # Vx = Qx + K'(Quu d) + K'Qu + Qux'd: Quu d (6), 12 per entry.
        n += 6 + 12 * nz
        # Vxx' = Qxx + K'Quu K + K'Qux + Qux'K on the upper triangle: K'Quu
        # (6 per row), then 12 per entry; K and Qux are dense over Qux's
        # columns.
        kc = Qux.any(0)
        Vxx = Qxx | (kc[:, None] & kc[None, :])
        n += 6 * int(kc.sum()) + 12 * int((Vxx & up).sum())
        flops += n
    return flops


def work(N: int, nz: int, B: int, itemsize: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one call at these shapes, for the roofline bound.

    Bytes: every input read once, every output written once. Per lane and
    stage that is 2 nz^2 + 5 nz + 8 values in (A, B, lx, lu, lxx, lux,
    luu, V) and 2 + 2 nz out (D, K); per lane once nz + nz^2 (gx, gxx) and
    one reg. FLOPs: `_stage_counts` over dense A and B (the callers'
    linearisations fill them), each value computed once.
    """
    per_stage_in = 2 * nz * nz + 5 * nz + 8
    per_stage_out = 2 + 2 * nz
    values = B * (N * (per_stage_in + per_stage_out) + nz + nz * nz + 1)
    flops = _stage_counts(N, torch.ones(nz, nz, dtype=torch.bool),
                          torch.ones(nz, 2, dtype=torch.bool))
    return B * flops, values * itemsize
