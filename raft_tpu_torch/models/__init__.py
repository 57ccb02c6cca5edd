from raft_tpu_torch.models.raft import RAFT  # noqa: F401
from raft_tpu_torch.models.ours import SparseRAFT  # noqa: F401
from raft_tpu_torch.models.deformable import (  # noqa: F401
    DeformableTransformerDecoderLayer, DeformableTransformerEncoder,
    DeformableTransformerEncoderLayer, MSDeformAttn)
