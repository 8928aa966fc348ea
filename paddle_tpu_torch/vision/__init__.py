"""``paddle_tpu_torch.vision`` (port of ``paddle_tpu/vision``): the models
and the zoo, transforms, datasets and the image backend.  ``vision.ops``
(the detection ops) is not ported yet."""

from . import transforms  # noqa: F401
from . import datasets  # noqa: F401
from . import models  # noqa: F401
from .image import get_image_backend, image_load, set_image_backend  # noqa: F401
