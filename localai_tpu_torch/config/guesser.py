"""Family-based chat-template/stopword guessing.

Port of ``localai_tpu/config/guesser.py`` (``FAMILY_SETTINGS``,
``identify_family``, ``guess_chat_defaults``, copied unchanged): a
template-less config pointing at a checkpoint gets its checkpoint's own
``tokenizer_config.json`` ``chat_template``, or else a chat template and
stopwords chosen by the model family its ``config.json`` shows
(architecture + special token ids): llama3, chatml (qwen2 / Yi-style
llama), phi3, gemma, mistral, command-r, deepseek2. The templates are
Jinja, rendered by the port's engine (``templates.engine``).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Optional

log = logging.getLogger(__name__)


def _tmpl(body_per_role: dict[str, str], generation: str,
          prefix: str = "") -> str:
    """Build a messages-loop Jinja chat template from per-role wrappers
    (each with a {content} slot) + the generation prompt tail."""
    branches = []
    first = True
    for role, wrap in body_per_role.items():
        kw = "if" if first else "elif"
        first = False
        branches.append(
            "{%% %s message['role'] == '%s' %%}%s"
            % (kw, role, wrap.replace("{content}", "{{ message['content'] }}"))
        )
    body = "".join(branches) + "{% endif %}"
    return (
        prefix
        + "{% for message in messages %}" + body + "{% endfor %}"
        + "{% if add_generation_prompt %}" + generation + "{% endif %}"
    )


_ROLE_GENERIC = "{content}"

FAMILY_SETTINGS: dict[str, dict[str, Any]] = {
    "llama3": {
        "stopwords": ["<|eot_id|>"],
        "chat_template": _tmpl(
            {r: "<|start_header_id|>" + r + "<|end_header_id|>\n\n"
                "{content}<|eot_id|>" for r in ("system", "user",
                                                "assistant")},
            "<|start_header_id|>assistant<|end_header_id|>\n\n",
            prefix="<|begin_of_text|>",
        ),
    },
    "chatml": {
        "stopwords": ["<|im_end|>"],
        "chat_template": _tmpl(
            {r: "<|im_start|>" + r + "\n{content}<|im_end|>\n"
             for r in ("system", "user", "assistant")},
            "<|im_start|>assistant\n",
        ),
    },
    "phi3": {
        "stopwords": ["<|end|>", "<|endoftext|>"],
        "chat_template": _tmpl(
            {r: "<|" + r + "|>\n{content}<|end|>\n"
             for r in ("system", "user", "assistant")},
            "<|assistant|>\n",
        ),
    },
    "gemma": {
        "stopwords": ["<end_of_turn>", "<start_of_turn>"],
        "chat_template": _tmpl(
            {"user": "<start_of_turn>user\n{content}<end_of_turn>\n",
             "assistant": "<start_of_turn>model\n{content}<end_of_turn>\n",
             "system": "<start_of_turn>user\n{content}<end_of_turn>\n"},
            "<start_of_turn>model\n",
        ),
    },
    "mistral": {
        "stopwords": ["</s>"],
        "chat_template": _tmpl(
            {"user": "[INST] {content} [/INST]",
             "assistant": "{content}</s>",
             "system": "[INST] {content} [/INST]"},
            "",
        ),
    },
    "command-r": {
        "stopwords": ["<|END_OF_TURN_TOKEN|>"],
        "chat_template": _tmpl(
            {"user": "<|START_OF_TURN_TOKEN|><|USER_TOKEN|>{content}"
                     "<|END_OF_TURN_TOKEN|>",
             "system": "<|START_OF_TURN_TOKEN|><|SYSTEM_TOKEN|>{content}"
                       "<|END_OF_TURN_TOKEN|>",
             "assistant": "<|START_OF_TURN_TOKEN|><|CHATBOT_TOKEN|>{content}"
                          "<|END_OF_TURN_TOKEN|>"},
            "<|START_OF_TURN_TOKEN|><|CHATBOT_TOKEN|>",
        ),
    },
    "deepseek2": {
        "stopwords": ["<｜end▁of▁sentence｜>"],
        "chat_template": _tmpl(
            {"user": "User: {content}\n",
             "assistant": "Assistant: {content}<｜end▁of▁sentence｜>",
             "system": "{content}\n"},
            "Assistant: ",
        ),
    },
}


def identify_family(hf: dict, name: str = "") -> Optional[str]:
    """config.json dict (+ model name) → family key, or None.

    Mirrors guesser.go identifyFamily: architecture + special token ids.
    """
    arch = str(hf.get("model_type", ""))
    eos = hf.get("eos_token_id")
    eos = eos[0] if isinstance(eos, list) and eos else eos
    bos = hf.get("bos_token_id")
    lname = name.lower()

    if arch == "deepseek_v2" or arch == "deepseek2":
        return "deepseek2"
    if arch.startswith("gemma") or "gemma" in lname:
        return "gemma"
    if arch == "llama" and eos == 128009:
        return "llama3"
    if arch == "cohere" or (arch == "command-r" and eos == 255001):
        return "command-r"
    if arch in ("phi3", "phi-3"):
        return "phi3"
    if arch == "qwen2":
        return "chatml"
    if arch == "llama" and bos == 1 and eos == 2:
        # Yi-style llama checkpoints ship ChatML formatting (guesser.go
        # isYI); plain llama2 with the same ids is indistinguishable, and
        # the reference makes the same call
        return "chatml"
    if arch == "mistral":
        return "mistral"
    return None


def guess_chat_defaults(cfg, model_path: str | Path) -> None:
    """Fill template.chat_template + stopwords on a template-less config
    whose checkpoint's tokenizer carries no chat template (parity:
    guessDefaultsFromFile, run at config load)."""
    t = cfg.template
    if (t.chat or t.chat_message or t.use_tokenizer_template
            or getattr(t, "chat_template", None)):
        return
    ref = cfg.model or cfg.name
    for cand in (Path(ref), Path(model_path) / ref):
        if not (cand / "config.json").exists():
            continue
        try:
            hf = json.loads((cand / "config.json").read_text())
        except ValueError:
            return
        tok_cfg = cand / "tokenizer_config.json"
        if tok_cfg.exists():
            try:
                own = json.loads(tok_cfg.read_text()).get("chat_template")
            except ValueError:
                own = None
            if own and isinstance(own, str):
                # the checkpoint knows its own format — carry the STRING
                # (converted-GGUF tokenizers are raw tokenizers.Tokenizer
                # objects with no apply_chat_template, so a bare
                # use_tokenizer_template flag would 500 at request time;
                # the explicit template renders through the Jinja fallback)
                t.chat_template = own
                return
        fam = identify_family(hf, cfg.name or "")
        if fam is None:
            return
        st = FAMILY_SETTINGS[fam]
        t.chat_template = st["chat_template"]
        if not cfg.stopwords:
            cfg.stopwords = list(st["stopwords"])
        log.info("model %s: guessed %s chat defaults (family templates)",
                 cfg.name, fam)
        return
