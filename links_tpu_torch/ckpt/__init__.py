"""Checkpoint import/export (reference ``.pt`` layout) and the serving
artifact (``export_io``)."""

from links_tpu_torch.ckpt.export_io import (
    deserialize_exported,
    export_serving,
    exported_info,
    load_exported,
)

__all__ = ["deserialize_exported", "export_serving", "exported_info", "load_exported"]
