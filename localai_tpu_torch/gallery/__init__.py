"""Model gallery: indexes, installs, async jobs.

Port of ``localai_tpu/gallery``: install = download files with sha256,
progress and resume, then write the declarative model config YAML into
the models dir; the ``/models/*`` routes (``api.gallery``), the CLI's
``models install|available`` and gallery preload drive it.
"""

from localai_tpu_torch.gallery.embedded import (
    EMBEDDED_MODELS,
    resolve_embedded,
)
from localai_tpu_torch.gallery.index import (
    Gallery,
    available_models,
    find_model,
    load_gallery_index,
    resolve_ref,
)
from localai_tpu_torch.gallery.models import (
    GalleryFile,
    GalleryModel,
    delete_model,
    install_model,
)
from localai_tpu_torch.gallery.service import (
    GalleryOp,
    GalleryService,
    JobStatus,
)
