"""Training steps, the counterpart of ``raft_tpu/parallel`` (one device so
far: the data-parallel and spatial meshes are not ported)."""
