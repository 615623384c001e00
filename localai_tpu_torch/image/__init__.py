"""Image generation on the port: the SD-1.x / SD-2.x / SDXL UNet
pipeline with its samplers, LoRA and ControlNet.

Port of ``localai_tpu/image/`` (its UNet family; the FLUX-class MMDiT is
ROADMAP item 10 part 2 and is refused at load, naming it). None of these
paths reaches a hand-written kernel: the JAX package runs them in XLA, and
the port in plain torch ops (``F.conv2d``, ``torch.matmul``, softmax), on
the card unless the caller asks for the CPU.
"""

from localai_tpu_torch.image.pipeline import (
    DiffusionPipeline,
    resolve_image_model,
)

__all__ = ["DiffusionPipeline", "resolve_image_model"]
