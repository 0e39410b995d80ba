#!/usr/bin/env python3
"""What the compiler made of each CUDA kernel: registers, shared memory and
spills per kernel instance, as ``nvcc -Xptxas -v`` reports them.

Compiles every source of the port's kernel library
(``repro_torch.kernels._lib.SOURCES``) with the library's own flags plus
``-Xptxas -v`` into a scratch directory, all sources at once, and prints
ptxas's lines for each (demangled kernel names), then the dynamic shared
memory the tensor-core kernels ask for, which ptxas does not see: flash
attention (K6's bfloat16 route) at each head dim, and the SSD scan's two
launches (K7's bfloat16 route) at each state width and chunk.  Needs ``nvcc``; the
listing builds nothing that the library uses, the last part loads the
library (building it at first use).

    python3 scripts/ptxas_report.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _lib

    nvcc = _lib._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(src, subprocess.Popen(
            [nvcc, *_lib.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o",
             str(Path(tmp) / (src.stem + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in _lib.SOURCES]
        failed = False
        for src, proc in procs:
            log, _ = proc.communicate()
            print(f"== {src.relative_to(ROOT)} (exit {proc.returncode})")
            lines = [l for l in log.splitlines() if "ptxas" in l or
                     "spill" in l or "error" in l]
            demangle = subprocess.run(["c++filt"], input="\n".join(lines),
                                      capture_output=True, text=True)
            print(demangle.stdout if demangle.returncode == 0
                  else "\n".join(lines))
            failed |= proc.returncode != 0
    if failed:
        return 1
    from repro_torch.kernels.flash_attention.ops import HEAD_DIMS
    smem = _lib.library().fa_flash_attention_wgmma_smem
    smem.argtypes, smem.restype = (ctypes.c_int,), ctypes.c_int
    print("== flash_wgmma_kernel dynamic shared memory (bytes) by head dim")
    print({hd: smem(hd) for hd in HEAD_DIMS})
    from repro_torch.kernels.ssd_scan.ops import TC_STATE_DIMS
    smem = _lib.library().ss_ssd_scan_wgmma_smem
    smem.argtypes, smem.restype = (ctypes.c_int,) * 3, ctypes.c_int
    for which, name in ((1, "ssd_state_kernel"), (2, "ssd_output_kernel")):
        print(f"== {name} dynamic shared memory (bytes) by state width, "
              f"chunk")
        print({f"{ns}, {Q}": smem(which, ns, Q) for ns in TC_STATE_DIMS
               for Q in (64, 128, 192, 256)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
