"""Times configurations of the port's kernels on one card: the float32
3xTF32 kernels (the split backward's and the bare rate of ``mma.sync`` in
TF32, the flash forward's, the fused backward's), the bf16 split dQ's
Hopper kernel, or the chunked IIR.

    python -m imagined_speech_translation_tpu_torch.cli.tune_split_bwd \
        [--program split_bwd|fwd_tf32|bwd_tf32|dq_bf16|sosfilt]

Builds ``csrc/tune/<program>.cu`` (which includes the kernel source,
``csrc/flash_bwd_split.cu``, ``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu`` or
``csrc/sosfilt.cu``) as a program under ``build/tune/`` with the kernel
library's ``nvcc`` flags, prints the card's name and power limit, the
registers and spills of the program's kernels under study as ptxas reports
them, then what the program prints: for each configuration, at (192, 1655,
128) and (96, 1655, 256) for the split backward (``dq_bf16``: in bf16), at
the serving shapes (384, 1655, 128) and (192, 1655, 256) and the training
shapes with dropout 0.1 for the forward, at the training shapes (96, 1655,
128) and (48, 1655, 256) with dropout 0.1 for the fused backward, the mean
milliseconds over 10 launches and the error against the CUDA-core kernels;
for ``sosfilt``, at (2000, 1651) and (125, 1651) with the serving filters,
the mean over 50 launches and the error against a sequential twin.  Needs
``nvcc`` and a card; the port never calls it.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys

from imagined_speech_translation_tpu_torch import _kernels
from imagined_speech_translation_tpu_torch.utils.cache import kernel_build_dir


#: each program: the kernel source it includes, and the name fragment of the
#: kernels whose ptxas lines it reports
PROGRAMS = {
    "split_bwd": ("flash_bwd_split.cu", "tf32_kernel"),
    "fwd_tf32": ("flash_fwd.cu", "tf32_kernel"),
    "bwd_tf32": ("flash_bwd.cu", "tf32_kernel"),
    "dq_bf16": ("flash_bwd_split.cu", "dq_wgmma_kernel"),
    "sosfilt": ("sosfilt.cu", "sosfilt_chunked_kernel"),
}


def sosfilt_args() -> list[str]:
    """The serving filters' sections (b0 b1 b2 a1 a2 of each, divided by
    a0, as the kernel gets them), as the ``sosfilt`` program's arguments."""
    from imagined_speech_translation_tpu_torch.frontend import SignalFrontend, sos_sections

    fe = SignalFrontend()
    return [repr(float(c)) for c in sos_sections([fe.sos_bandpass, fe.sos_notch]).ravel()]


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
    ap.add_argument("--program", choices=tuple(PROGRAMS), default="split_bwd")
    args = ap.parse_args(argv)
    src = _kernels.CSRC / "tune" / f"{args.program}.cu"
    exe = kernel_build_dir().parent / "tune" / args.program
    exe.parent.mkdir(parents=True, exist_ok=True)
    build = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(exe), str(src)],
                           capture_output=True, text=True)
    if build.returncode != 0:
        print(build.stdout + build.stderr, file=sys.stderr)
        return build.returncode
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    for line in ptxas_lines(build.stdout + build.stderr, PROGRAMS[args.program][1]):
        print(line)
    sys.stdout.flush()
    extra = sosfilt_args() if args.program == "sosfilt" else []
    return subprocess.run([str(exe), *extra]).returncode


if __name__ == "__main__":
    sys.exit(main())
