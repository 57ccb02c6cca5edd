"""raft_tpu_torch: RAFT optical flow in PyTorch for an NVIDIA H100.

The PyTorch and CUDA port of the JAX package ``raft_tpu``, which stays the
reference it is tested against. Module names follow ``raft_tpu``'s. It
covers RAFT-large in float32: inference (``evaluate.FlowPredictor``) and
training (``train.train``), both through ``models.raft.RAFT``, whose
refinement loop runs CUDA kernels written for Hopper: the windowed
correlation lookup and its backward (``ops/corr_cuda.py``,
``csrc/corr_fwd.cu``, ``csrc/corr_bwd.cu``) and the update step
(``ops/step_cuda.py``, ``csrc/update_step.cu``), or the motion encoder and
the SepConvGRU cell (``ops/motion_cuda.py``, ``ops/gru_cuda.py``), all
built by ``nvcc`` on first use (``ops/build.py``). On the CPU each kernel's
plain PyTorch version runs in its place. This package never imports JAX or
``raft_tpu``.
"""
