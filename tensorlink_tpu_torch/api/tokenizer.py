"""Tokenizer resolution for hosted models.

The reference pulls ``AutoTokenizer`` for every hosted job
(ml/validator.py:971 wires tokenizer into the hosted DistributedModel). Here
HF tokenizers are used when a checkpoint/tokenizer is available; otherwise a
deterministic byte-level fallback keeps offline tests and synthetic models
servable (vocab = 256 bytes + BOS/EOS sentinels).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

from tensorlink_tpu_torch.core.logging import get_logger

log = get_logger("api.tokenizer")


class ByteTokenizer:
    """UTF-8 byte fallback: id = byte value; 256=BOS, 257=EOS."""

    vocab_size = 258
    bos_token_id = 256
    eos_token_id = 257
    chat_template = None
    model_max_length = 1 << 20

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        ids = list(text.encode("utf-8"))
        if add_special_tokens:
            ids = [self.bos_token_id] + ids
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        bs = bytes(i for i in ids if 0 <= int(i) < 256)
        return bs.decode("utf-8", errors="replace")

    def __call__(self, text: str, **kw) -> dict:
        return {"input_ids": self.encode(text)}


class TokenizerAdapter:
    """Uniform surface over HF tokenizers and the byte fallback."""

    def __init__(self, tok: Any):
        self.tok = tok

    @property
    def chat_template(self):
        return getattr(self.tok, "chat_template", None)

    @property
    def eos_ids(self) -> list[int]:
        eid = getattr(self.tok, "eos_token_id", None)
        if eid is None:
            return []
        return [eid] if isinstance(eid, int) else list(eid)

    @property
    def model_max_length(self) -> int:
        n = int(getattr(self.tok, "model_max_length", 1 << 20) or 1 << 20)
        return min(n, 1 << 20)  # HF uses huge sentinels for "unset"

    def apply_chat_template(self, *a, **kw):
        return self.tok.apply_chat_template(*a, **kw)

    def encode(self, text: str) -> list[int]:
        return list(self.tok.encode(text, add_special_tokens=False))

    def decode(self, ids) -> str:
        return self.tok.decode(list(ids), skip_special_tokens=True)


def load_tokenizer(model_spec: dict) -> TokenizerAdapter:
    """Checkpoint dir with tokenizer files → AutoTokenizer; known HF name →
    AutoTokenizer (may hit cache offline); otherwise byte fallback."""
    ckpt = model_spec.get("ckpt")
    candidates = []
    if ckpt and Path(str(ckpt)).is_dir():
        d = Path(str(ckpt))
        if (d / "tokenizer.json").exists() or (d / "tokenizer_config.json").exists():
            candidates.append(str(d))
    name = model_spec.get("name", "")
    if "/" in name:
        candidates.append(name)
    for cand in candidates:
        try:
            from transformers import AutoTokenizer

            return TokenizerAdapter(AutoTokenizer.from_pretrained(cand))
        except Exception as e:
            log.debug("tokenizer candidate %s unavailable: %s", cand, e)
            continue
    return TokenizerAdapter(ByteTokenizer())
