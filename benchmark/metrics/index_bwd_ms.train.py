"""Device ms per training step in PyTorch's advanced-indexing backward
(the own device time of the index_put operators)."""
from benchlib.readers import index_bwd_ms as read  # noqa: F401
