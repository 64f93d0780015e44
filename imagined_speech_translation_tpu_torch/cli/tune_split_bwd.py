"""Times configurations of the float32 3xTF32 kernels on one card: the
split backward's and the bare rate of ``mma.sync`` in TF32, the flash
forward's, or the fused backward's.

    python -m imagined_speech_translation_tpu_torch.cli.tune_split_bwd \
        [--program split_bwd|fwd_tf32|bwd_tf32]

Builds ``csrc/tune/<program>.cu`` (which includes the kernel source,
``csrc/flash_bwd_split.cu``, ``csrc/flash_fwd.cu`` or ``csrc/flash_bwd.cu``)
as a program under ``build/tune/`` with the kernel library's ``nvcc`` flags,
prints the card's name and power limit, each 3xTF32 kernel's registers and
spills as ptxas reports them, then what the program prints: for each
configuration, at (192, 1655, 128) and (96, 1655, 256) for the split
backward, at the serving shapes (384, 1655, 128) and (192, 1655, 256) and
the training shapes with dropout 0.1 for the forward, at the training shapes
(96, 1655, 128) and (48, 1655, 256) with dropout 0.1 for the fused backward,
the mean milliseconds over 10 launches and the error against the CUDA-core
kernels.  Needs ``nvcc`` and a card; the port never calls it.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys

from imagined_speech_translation_tpu_torch import _kernels


def ptxas_lines(log: str, fragment: str = "tf32_kernel") -> list[str]:
    """``entry: registers/spills`` lines of the entry functions whose mangled
    name contains ``fragment``."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1) if fragment in m.group(1) else None
        elif entry and ("registers" in line or "spill" in line):
            out.append(f"{entry}: {line.strip()}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--program", choices=("split_bwd", "fwd_tf32", "bwd_tf32"),
                    default="split_bwd")
    args = ap.parse_args(argv)
    src = _kernels.CSRC / "tune" / f"{args.program}.cu"
    exe = _kernels.BUILD_DIR.parent / "tune" / args.program
    exe.parent.mkdir(parents=True, exist_ok=True)
    build = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(exe), str(src)],
                           capture_output=True, text=True)
    if build.returncode != 0:
        print(build.stdout + build.stderr, file=sys.stderr)
        return build.returncode
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    for line in ptxas_lines(build.stdout + build.stderr):
        print(line)
    sys.stdout.flush()
    return subprocess.run([str(exe)]).returncode


if __name__ == "__main__":
    sys.exit(main())
