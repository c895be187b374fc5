"""respmon_tpu_torch — the PyTorch/CUDA port of ``respmon_tpu``.

Same layout and public functions as the JAX package (``ops/...``,
``pipeline/...``, ``runtime/...``), tested against it on the CPU and run
on an NVIDIA Hopper GPU, where the Pallas pyramid kernels are hand-written
CUDA (``csrc/pyramid.cu``, ``csrc/band_mm.cu``).  Covered so far: the live
single-stream monitor ``runtime.RespiratoryMonitor`` with its host side
(``io/``, ``viz/``, ``utils/bench``) and CLI (``python -m
respmon_tpu_torch``), the whole-clip path ``pipeline.scan.process_clip``
/ ``process_clip_auto``, in average and flow mode, the multi-stream fleet
``parallel.streams.MultiStreamMonitor``, checkpoint / resume
(``runtime.checkpoint``) and the sharded paths over ``torch.distributed``
(``parallel/{mesh,launch,temporal,spatial}``).

Precision policy (the port's counterpart of the JAX package's
``Precision.HIGHEST`` rule): float32 matrix products and convolutions run
in full float32, never TF32.  The temporal bandpass operator amplifies by
500, and a TF32 product moves heatmap pixels across u8 boundaries, which
moves bbox edges.  This is the one place the policy is set.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
