"""Image generation on the port: the SD-1.x / SD-2.x / SDXL UNet
pipeline with its samplers, LoRA and ControlNet, and the FLUX-class
pipeline (T5 and CLIP conditioning, the rectified-flow MMDiT).

Port of ``localai_tpu/image/``. None of these paths reaches a
hand-written kernel: the JAX package runs them in XLA, and the port in
plain torch ops (``F.conv2d``, ``torch.matmul``, softmax), on the card
unless the caller asks for the CPU.
"""

from localai_tpu_torch.image.pipeline import (
    DiffusionPipeline,
    resolve_image_model,
)

__all__ = ["DiffusionPipeline", "resolve_image_model"]
