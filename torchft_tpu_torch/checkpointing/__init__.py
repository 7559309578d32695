from torchft_tpu_torch.checkpointing._rwlock import RWLock
from torchft_tpu_torch.checkpointing.durable import DurableCheckpointer
from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
from torchft_tpu_torch.checkpointing.pg_transport import PGTransport
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport

__all__ = ["RWLock", "CheckpointTransport", "DurableCheckpointer", "HTTPTransport", "PGTransport"]
