"""Image generation: POST /v1/images/generations and the
GET /generated-images/{name} file route.

Port of ``localai_tpu/api/images.py`` as framework-free functions that
``api.server`` maps HTTP onto, with the JAX package's fields, statuses and
JSON: ``"positive|negative"`` prompt splitting, a list of prompts, ``n``
copies of each (seeds ``seed + j``), ``size`` "WxH" (at most 2048 a side),
``step`` / ``seed`` over the model's ``diffusers:`` and ``parameters:``
defaults, ``file`` as the img2img init image (or the control image when a
ControlNet is attached), and ``b64_json`` or ``url`` answers (url files
land in ``image_path`` and are served under ``/generated-images/``,
path-guarded). An unknown model is a 404; a model without the image
usecase, a bad ``size`` and an undecodable ``file`` are 400s.

Where the JAX package calls PIL, the port has its own: ``file`` is
fetched and decoded by ``utils.media`` (an http(s) URL, raw base64 as
there, and also a data URI), the bucketed image is resized to the
requested size by ``utils.resample.resize`` (Pillow's BICUBIC, which
``Image.resize`` defaults to) and encoded by ``utils.png.encode``.
"""

from __future__ import annotations

import base64
import time
import uuid
from pathlib import Path

import numpy as np

from localai_tpu_torch.api.openai import APIError, request_body

PNG = "image/png"


def parse_size(size: str) -> tuple[int, int]:
    """"WxH" → (width, height); empty → 512x512."""
    if not size:
        return 512, 512
    parts = str(size).lower().split("x")
    try:
        w, h = int(parts[0]), int(parts[1])
    except (ValueError, IndexError):
        raise APIError(400, "invalid value for 'size'") from None
    if w <= 0 or h <= 0 or w > 2048 or h > 2048:
        raise APIError(400, "invalid value for 'size' (max 2048)")
    return w, h


def _init_image(file_ref: str) -> np.ndarray:
    """``file`` → an RGB uint8 array (the init or control image)."""
    from localai_tpu_torch.utils import media

    try:
        data = media.fetch_image_bytes(file_ref, kind="file")
    except media.MediaError as e:
        raise APIError(400, str(e)) from None
    try:
        return media.decode_image(data)
    except media.MediaError as e:
        raise APIError(400, f"cannot decode init image: {e}") from None


def finalize_png(img: np.ndarray, width: int, height: int) -> bytes:
    """The pipeline buckets sizes to multiples of 64: resize to exactly
    what was asked for, then encode."""
    from localai_tpu_torch.utils import png, resample

    if img.shape[:2] != (height, width):
        img = resample.resize(img, (width, height))
    return png.encode(img)


def _store_png(data: bytes, image_path: str) -> str:
    name = f"{uuid.uuid4().hex}.png"
    out = Path(image_path)
    out.mkdir(parents=True, exist_ok=True)
    (out / name).write_bytes(data)
    return name


def _image_model(manager, name: str):
    try:
        return manager.get_image(name)
    except (KeyError, FileNotFoundError) as e:
        raise APIError(404, str(e)) from None


def generations(manager, body: dict, base_url: str = "") -> dict:
    """POST /v1/images/generations. ``base_url`` (scheme and host of the
    request) prefixes the url answers."""
    body = request_body(body)
    name = body.get("model") or ""
    mcfg = manager.loader.get(name)
    if mcfg is None:
        raise APIError(404, f"model {name!r} not found; available: "
                            f"{manager.loader.names()}")
    if not mcfg.has_usecase("image"):
        raise APIError(400, f"model {name!r} does not support image "
                            "generation")
    width, height = parse_size(body.get("size") or "")
    prompt = body.get("prompt")
    prompts = prompt if isinstance(prompt, list) else [prompt or ""]
    try:
        n = int(body.get("n") or mcfg.parameters.n or 1)
        steps = int(body.get("step") or mcfg.diffusers.steps or 0)
        seed = body.get("seed")
        seed = int(seed) if seed is not None else mcfg.parameters.seed
    except (TypeError, ValueError):
        raise APIError(400, "n, step and seed must be integers") from None
    fmt = body.get("response_format") or ""
    b64 = fmt == "b64_json" or (isinstance(fmt, dict)
                                and fmt.get("type") == "b64_json")
    init = _init_image(body["file"]) if body.get("file") else None

    sm = _image_model(manager, name)
    items = []
    with sm.in_use():  # busy across the batch: no eviction mid-request
        # with a ControlNet attached, the request's image guides (control)
        # instead of seeding img2img
        has_cn = getattr(sm.pipeline, "controlnet_params", None) is not None
        for text in prompts:
            pos, _, neg = (text or "").partition("|")
            for j in range(n):
                result = sm.generate(
                    pos, negative_prompt=neg, width=width, height=height,
                    steps=steps or None,
                    seed=None if seed is None else int(seed) + j,
                    init_image=None if has_cn else init,
                    control_image=init if has_cn else None,
                    control_scale=mcfg.diffusers.control_scale)
                data = finalize_png(result.image, width, height)
                if b64:
                    items.append({"b64_json": base64.b64encode(data)
                                  .decode()})
                else:
                    stored = _store_png(data, manager.app.image_path)
                    items.append(
                        {"url": f"{base_url}/generated-images/{stored}"})
    return {"id": uuid.uuid4().hex, "created": int(time.time()),
            "data": items}


def serve_generated(manager, query: dict, name: str) -> tuple[str, bytes]:
    """GET /generated-images/{name}: a stored image, confined to
    ``image_path``."""
    root = Path(manager.app.image_path).resolve()
    target = (root / name).resolve()
    if root not in target.parents or not target.is_file():
        raise APIError(404, "image not found")
    return PNG, target.read_bytes()
