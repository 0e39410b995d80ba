"""Roofline terms of one traced step (port of ``repro.launch.roofline``).

    compute term    = FLOPs per device / peak FLOP/s
    memory term     = bytes per device / HBM bandwidth
    collective term = collective wire bytes per device / network bandwidth

The dry run (``launch.dryrun``) traces one rank's step, so every count is
already per device, as XLA's ``cost_analysis`` of a GSPMD program is.

Collective bytes come from the collective log the trace records
(``core.lanes``: ``(kind, operand shape, result shape, dtype, group
size, axis)`` per call), with the JAX package's ring formulas:

    all-gather(result R bytes, group g):      R * (g-1)/g        received
    reduce-scatter(operand O bytes, group g): O * (g-1)/g        sent
    all-reduce(operand O bytes, group g):     2 * O * (g-1)/g    (RS + AG)
    all-to-all(operand O bytes, group g):     O * (g-1)/g
    collective-permute(operand O bytes):      O

Hardware constants (NVIDIA H100 SXM5):

- ``PEAK_FLOPS`` = 989e12: dense bfloat16 tensor-core peak (NVIDIA H100
  data sheet; ``chip_smoke.py``'s ``PEAK_BF16_FLOPS``).
- ``HBM_BW`` = 3.35e12 B/s: HBM3 bandwidth (the data sheet;
  ``chip_smoke.py``'s ``MEM_BYTES_PER_S``).
- ``NET_BW`` = 50e9 B/s per GPU: one 400 Gb/s NDR InfiniBand adapter per
  GPU, as a DGX H100 has.  Every axis of the 16 x 16 production mesh
  spans more than one 8-GPU NVLink node, so each collective's ring
  crosses InfiniBand; NVLink 4, the in-node rate, is ``NVLINK_BW`` =
  450e9 B/s per direction (900 GB/s both ways), named but not used.

The JAX module's ``normalize_cost_analysis`` and its HLO-text parser have
no counterpart: there is no compiled program and no HLO here; the trace
counts operations as they dispatch and collectives as they run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Sequence

import torch

__all__ = ["HW", "PEAK_FLOPS", "HBM_BW", "NET_BW", "NVLINK_BW",
           "COLLECTIVES", "RooflineReport", "analyze", "collective_bytes",
           "record_bytes"]

PEAK_FLOPS = 989e12        # dense bf16 per GPU
HBM_BW = 3.35e12           # bytes/s per GPU
NET_BW = 50e9              # bytes/s per GPU (400 Gb/s NDR)
NVLINK_BW = 450e9          # bytes/s per GPU per direction (in-node)

HW = {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "net_bw": NET_BW}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def record_bytes(shape: Sequence[int], dtype: str) -> int:
    """Bytes of a recorded tensor: its elements times its dtype's size."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * torch.empty((), dtype=getattr(torch, dtype)).element_size()


def collective_bytes(records: Iterable[tuple], n_devices: int
                     ) -> Dict[str, float]:
    """Estimated per-device wire bytes by collective kind (ring
    algorithm) for one run of the traced step: ``records`` the lanes'
    log, a record's group size ``n_devices`` where it names none."""
    out: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
    for kind, operand, result, dtype, group, _axis in records:
        g = int(group or n_devices)
        frac = (g - 1) / g if g > 1 else 0.0
        if kind == "all-gather":
            out[kind] += record_bytes(result, dtype) * frac
        elif kind == "reduce-scatter":
            out[kind] += record_bytes(operand, dtype) * frac
        elif kind == "all-reduce":
            out[kind] += 2.0 * record_bytes(operand, dtype) * frac
        elif kind == "all-to-all":
            out[kind] += record_bytes(operand, dtype) * frac
        elif kind == "collective-permute":
            out[kind] += record_bytes(operand, dtype)
        else:
            raise ValueError(f"unknown collective {kind!r}")
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_breakdown: Dict[str, float]
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float            # 6*N*D analytic (global)
    useful_ratio: float           # model_flops / (flops_per_device * chips)
    peak_memory_bytes: int        # the traced peak
    argument_bytes: int
    output_bytes: int
    temp_bytes: int

    def terms(self) -> Dict[str, float]:
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s}


def terms(flops: float, nbytes: float, coll: float) -> Dict[str, float]:
    """The three roofline terms in seconds."""
    return {"compute_s": flops / PEAK_FLOPS, "memory_s": nbytes / HBM_BW,
            "collective_s": coll / NET_BW}


def bottleneck(t: Dict[str, float]) -> str:
    return max([("compute", t["compute_s"]), ("memory", t["memory_s"]),
                ("collective", t["collective_s"])], key=lambda kv: kv[1])[0]


def analyze(*, arch: str, shape: str, mesh_name: str, n_devices: int,
            model_flops: float, flops: float, nbytes: float,
            records: Iterable[tuple], memory: Dict[str, int]
            ) -> RooflineReport:
    """The report of one traced step: its per-device FLOPs and bytes, its
    collective log and its memory (``argument_bytes``, ``output_bytes``,
    ``temp_bytes``, ``peak_bytes``)."""
    coll = collective_bytes(records, n_devices)
    t = terms(flops, nbytes, coll["total"])
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, flops_per_device=flops,
        bytes_per_device=nbytes, collective_bytes_per_device=coll["total"],
        collective_breakdown={k: v for k, v in coll.items() if k != "total"},
        bottleneck=bottleneck(t), model_flops=model_flops,
        useful_ratio=(model_flops / (flops * n_devices)) if flops else 0.0,
        peak_memory_bytes=int(memory["peak_bytes"]),
        argument_bytes=int(memory["argument_bytes"]),
        output_bytes=int(memory["output_bytes"]),
        temp_bytes=int(memory["temp_bytes"]), **t)
