"""raft_tpu_torch: RAFT optical flow in PyTorch for an NVIDIA H100.

The PyTorch and CUDA port of the JAX package ``raft_tpu``, which stays the
reference it is tested against. Module names follow ``raft_tpu``'s. It
covers RAFT-large in float32: inference (``evaluate.FlowPredictor``, with
RAFT's serving entry points: early exit, warm start, the stream's encode
and refine, the step-granular refine; ``entry.entry``) and training
(``train.train``), and RAFT-small's inference, all through
``models.raft.RAFT``, whose refinement loop runs CUDA kernels written for
Hopper (RAFT-small: the lookup only; its update block is cuDNN): the windowed
correlation lookup and its backward (``ops/corr_cuda.py``,
``csrc/corr_fwd.cu``, ``csrc/corr_bwd.cu``) and the update step
(``ops/step_cuda.py``, ``csrc/update_step.cu``), or the motion encoder and
the SepConvGRU cell (``ops/motion_cuda.py``, ``ops/gru_cuda.py``). It also
covers inference of the sparse-keypoint family (``models.ours.SparseRAFT``,
``load_predictor(..., model_family="sparse")``), which runs the corr kernel
at the family's lookup (no per-level rescale) and multi-scale deformable
attention (``ops/msda.py``, ``ops/msda_cuda.py``, ``csrc/msda_fwd.cu``).
Every kernel is built by ``nvcc`` on first use (``ops/build.py``). On the
CPU each kernel's plain PyTorch version runs in its place. This package
never imports JAX or ``raft_tpu``.
"""
