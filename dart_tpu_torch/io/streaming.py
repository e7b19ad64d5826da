"""Per-step telemetry from the episode loops into the native ring (port of
`dart_tpu.io.streaming`).

The reference keeps telemetry off the control path by shipping it to a
logger process through a queue (`PMPC/src/logger.py:39-148`). The port's
loops run on the host, so a record is a plain call per step: `emit` reads
the step's few scalars from the device in one copy and pushes the record
into the ring (`io.ringlog.RingLogger`), which drops and counts on
overflow, the reference's lossy-telemetry semantics.

    tap = TelemetryTap(path, EPISODE_STREAM_DTYPE)
    ...each step...  tap.emit(k=k, px=..., py=..., ux=..., uy=..., err=...)
    tap.close(); arr = RingLogger.read(path, EPISODE_STREAM_DTYPE)
"""

from __future__ import annotations

import numpy as np
import torch

from dart_tpu_torch.io.ringlog import RingLogger

# Per-step record of the episode drivers (`cli/pmpc --stream`,
# `rollout.evaluate.make_pmpc_evaluator(tap=...)`).
EPISODE_STREAM_DTYPE = np.dtype([("k", "<i4"), ("px", "<f4"), ("py", "<f4"),
                                 ("ux", "<f4"), ("uy", "<f4"),
                                 ("err", "<f4")])


class TelemetryTap:
    """One record per `emit` into a `RingLogger`. `record_dtype` is a
    structured numpy dtype; `emit` takes one keyword per field, each a
    python number, a numpy value or a tensor of the field's shape."""

    def __init__(self, path: str, record_dtype: np.dtype,
                 capacity_records: int = 1 << 16):
        self.dtype = np.dtype(record_dtype)
        self.logger = RingLogger(path, self.dtype, capacity_records)

    def emit(self, **fields) -> bool:
        """Push one record; the tensor fields cross to the host in one
        `.cpu()` of their concatenation. Returns False if the ring dropped
        it."""
        rec = np.zeros((), self.dtype)
        tens = [(n, fields[n]) for n in self.dtype.names
                if isinstance(fields[n], torch.Tensor)]
        if tens:
            flat = torch.cat([v.reshape(-1).to(torch.float64)
                              for _, v in tens]).cpu().numpy()
            i = 0
            for n, v in tens:
                rec[n] = flat[i:i + v.numel()].reshape(v.shape)
                i += v.numel()
        for n in self.dtype.names:
            if not isinstance(fields[n], torch.Tensor):
                rec[n] = fields[n]
        return self.logger.push(rec)

    def stats(self) -> dict:
        return self.logger.stats()

    def close(self):
        self.logger.close()
