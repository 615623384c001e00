"""Audio on the port: wav I/O, the log-mel frontend, the VITS voice, the
speaker encoder, the parametric synthesiser and MusicGen-class sound
generation.

Port of ``localai_tpu/audio/``. None of these paths reaches a hand-written
kernel: the JAX package computes them in XLA, and the port in plain torch
ops, on the card unless the caller asks for the CPU. Float32 convs and
matmuls run with TF32 off (``utils.device.full_f32``), as float32 in the
JAX package is full float32. Noise is drawn from seeded
``torch.Generator``s: a seed reproduces the port's own audio, never the
JAX package's ``jax.random`` draws (each sampling function takes the noise
as an argument, so a test can feed it those).
"""

from localai_tpu_torch.audio.wav import read_wav, write_wav

__all__ = ["read_wav", "write_wav"]
