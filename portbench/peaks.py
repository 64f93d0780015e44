"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit): a copy of ``chip_smoke.py``'s table.  The float32 entry
is the port's f32 path, 3xTF32 on the tensor cores: a third of TF32's
495 TFLOP/s."""

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
HBM_BYTES_PER_S = 3.35e12
