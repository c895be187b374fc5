"""respmon_tpu_torch — the PyTorch/CUDA port of ``respmon_tpu``.

Same layout and public functions as the JAX package (``ops/...``,
``pipeline/...``, ``runtime/...``), tested against it on the CPU and run
on an NVIDIA Hopper GPU, where the Pallas pyramid kernels are hand-written
CUDA (``csrc/pyramid.cu``, ``csrc/band_mm.cu``).  Covered: the live
single-stream monitor ``runtime.RespiratoryMonitor`` with its host side
(``io/``, ``viz/``, ``utils/bench``) and CLI (``python -m
respmon_tpu_torch``), the whole-clip path ``pipeline.scan.process_clip``
/ ``process_clip_auto``, in average and flow mode, the multi-stream fleet
``parallel.streams.MultiStreamMonitor``, checkpoint / resume
(``runtime.checkpoint``), the sharded paths over ``torch.distributed``
(``parallel/{mesh,launch,temporal,spatial}``), the auxiliary modules
(``ops/dtype``'s converters, ``ops/detect_peaks``, ``ops/wavelets``,
``utils/diagnostics``, ``version``), the JAX package's nine demos
(``examples/``, ``python -m respmon_tpu_torch.examples.<name>``) and the
counterpart of ``__graft_entry__.py`` (``entry``): every public name of
the JAX package, with its arguments.  Left out on purpose (ROADMAP.md
lists each with its reason): ``gaussfit.jacobian_fd`` (never reached in
production), LK's ``"onehot"`` / ``"onehot1"`` / ``"patches"`` sampling
modes (gather strategies for the TPU, equal to ``"slices"``), the Pallas
kernels' own names, ``bpm.estimate_bpm_jit``, ``lk.level_geometry``'s
``win`` and the JAX device arguments of ``parallel/mesh``.

Precision policy (the port's counterpart of the JAX package's
``Precision.HIGHEST`` rule): float32 matrix products and convolutions run
in full float32, never TF32.  The temporal bandpass operator amplifies by
500, and a TF32 product moves heatmap pixels across u8 boundaries, which
moves bbox edges.  This is the one place the policy is set.
"""

import torch

from respmon_tpu_torch.version import __version__

__all__ = ["__version__"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
