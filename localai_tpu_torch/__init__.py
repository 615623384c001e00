"""PyTorch/CUDA port of the localai_tpu serving engine, for one NVIDIA H100.

The module layout mirrors ``localai_tpu`` so each counterpart is easy to
find (``models/llama.py``, ``engine/runner.py``, ``ops/attention.py`` ...),
but nothing here imports JAX or the JAX package: the runtime stands on the
standard library, numpy and torch alone. Imports of anything else (``yaml``
for a config file, ``tokenizers`` for an HF tokenizer) happen inside the
function that needs them.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU explicitly; with no card they raise instead of moving to the
CPU on their own.
"""

__version__ = "0.1.0"
