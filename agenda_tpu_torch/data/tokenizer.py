"""Native CLIP byte-level BPE tokenizer (framework-owned, no HF dependency).

The port's own copy of ``agenda_tpu/data/tokenizer.py`` (the port imports nothing of
agenda_tpu, not even its numpy-only modules).

Loads the standard ``vocab.json`` / ``merges.txt`` pair from a pipeline's
``tokenizer/`` directory (the format the reference's checkpoints ship,
consumed there via ``transformers.CLIPTokenizer`` —
``data_generation/finetune_sd.py:487-489``). Behavior matches HF's
CLIPTokenizer on the same files: lowercasing + whitespace cleanup, the CLIP
regex pre-split, byte-to-unicode mapping, rank-ordered BPE with ``</w>``
word-final markers, BOS/EOS wrapping, EOS padding/truncation to
``model_max_length`` (77).

Supports ``add_tokens`` for the learnable-token workflow
(``data_generation/data_generation.py:47-49``): added tokens are matched
verbatim before BPE and get ids past the end of the base vocab.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

try:
    import regex as _re

    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except ImportError:  # pragma: no cover - regex is available in this image
    import re as _re

    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
        _re.IGNORECASE,
    )


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte -> printable unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Sequence[str]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class CLIPTokenizer:
    def __init__(
        self,
        vocab: Dict[str, int],
        merges: List[str],
        model_max_length: int = 77,
        bos_token: str = "<|startoftext|>",
        eos_token: str = "<|endoftext|>",
        pad_token: Optional[str] = None,
    ):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.model_max_length = model_max_length
        self.bos_token, self.eos_token = bos_token, eos_token
        self.pad_token = pad_token or eos_token
        self.added_tokens: Dict[str, int] = {}
        self._bpe_cache: Dict[str, str] = {}

    # -- construction -------------------------------------------------------

    @classmethod
    def from_pretrained(cls, tokenizer_dir: str) -> "CLIPTokenizer":
        with open(os.path.join(tokenizer_dir, "vocab.json")) as f:
            vocab = json.load(f)
        with open(os.path.join(tokenizer_dir, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [l for l in lines if l and not l.startswith("#version")]
        cfg_path = os.path.join(tokenizer_dir, "tokenizer_config.json")
        kwargs = {}
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)

            def tok(v):
                return v["content"] if isinstance(v, dict) else v

            kwargs = dict(
                model_max_length=cfg.get("model_max_length", 77),
                bos_token=tok(cfg.get("bos_token", "<|startoftext|>")),
                eos_token=tok(cfg.get("eos_token", "<|endoftext|>")),
                pad_token=tok(cfg.get("pad_token")) if cfg.get("pad_token") else None,
            )
        tk = cls(vocab, merges, **kwargs)
        added_path = os.path.join(tokenizer_dir, "added_tokens.json")
        if os.path.exists(added_path):
            with open(added_path) as f:
                for t, i in sorted(json.load(f).items(), key=lambda kv: kv[1]):
                    tk.added_tokens[t] = i
        return tk

    def save_pretrained(self, tokenizer_dir: str) -> None:
        os.makedirs(tokenizer_dir, exist_ok=True)
        with open(os.path.join(tokenizer_dir, "vocab.json"), "w") as f:
            json.dump(self.encoder, f, ensure_ascii=False)
        merges = sorted(self.bpe_ranks.items(), key=lambda kv: kv[1])
        with open(os.path.join(tokenizer_dir, "merges.txt"), "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n" + "\n".join(" ".join(p) for p, _ in merges) + "\n")
        with open(os.path.join(tokenizer_dir, "tokenizer_config.json"), "w") as f:
            json.dump(
                {
                    "model_max_length": self.model_max_length,
                    "bos_token": self.bos_token,
                    "eos_token": self.eos_token,
                    "pad_token": self.pad_token,
                    "tokenizer_class": "CLIPTokenizer",
                },
                f,
            )
        if self.added_tokens:
            with open(os.path.join(tokenizer_dir, "added_tokens.json"), "w") as f:
                json.dump(self.added_tokens, f)

    # -- vocab --------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.encoder) + len(self.added_tokens)

    @property
    def bos_token_id(self) -> int:
        return self.encoder[self.bos_token]

    @property
    def eos_token_id(self) -> int:
        return self.encoder[self.eos_token]

    @property
    def pad_token_id(self) -> int:
        return self.encoder.get(self.pad_token, self.eos_token_id)

    def add_tokens(self, tokens: List[str]) -> int:
        """Register new literal tokens (learnable token workflow). Returns #added."""
        n = 0
        for t in tokens:
            if t in self.encoder or t in self.added_tokens:
                continue
            self.added_tokens[t] = len(self)
            n += 1
        return n

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            tokens = [tokens]
        out = []
        for t in tokens:
            if t in self.added_tokens:
                out.append(self.added_tokens[t])
            else:
                out.append(self.encoder[t])
        return out

    # -- BPE ----------------------------------------------------------------

    def _bpe(self, token: str) -> str:
        if token in self._bpe_cache:
            return self._bpe_cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        result = " ".join(word)
        self._bpe_cache[token] = result
        return result

    def tokenize(self, text: str) -> List[str]:
        """Text -> BPE sub-token strings (no BOS/EOS)."""
        text = " ".join(text.split()).strip().lower()
        tokens: List[str] = []
        # Added tokens split first (verbatim match, longest-first).
        segments = [text]
        for added in sorted(self.added_tokens, key=len, reverse=True):
            new_segments = []
            for seg in segments:
                if isinstance(seg, tuple):
                    new_segments.append(seg)
                    continue
                parts = seg.split(added)
                for i, p in enumerate(parts):
                    if i > 0:
                        new_segments.append(("added", added))
                    if p:
                        new_segments.append(p)
            segments = new_segments
        for seg in segments:
            if isinstance(seg, tuple):
                tokens.append(seg[1])
                continue
            for tok in _PAT.findall(seg):
                tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
                tokens.extend(self._bpe(tok).split(" "))
        return tokens

    def _token_to_id(self, tok: str) -> int:
        if tok in self.added_tokens:
            return self.added_tokens[tok]
        return self.encoder.get(tok, self.eos_token_id)

    def encode(
        self,
        text: str,
        max_length: Optional[int] = None,
        padding: str = "max_length",
        truncation: bool = True,
    ) -> List[int]:
        """Text -> [BOS] ids [EOS] (+ padding), matching HF CLIPTokenizer output."""
        ids = [self._token_to_id(t) for t in self.tokenize(text)]
        max_length = max_length or self.model_max_length
        if truncation and len(ids) > max_length - 2:
            ids = ids[: max_length - 2]
        ids = [self.bos_token_id] + ids + [self.eos_token_id]
        if padding == "max_length" and len(ids) < max_length:
            ids = ids + [self.pad_token_id] * (max_length - len(ids))
        return ids

    def __call__(self, text, max_length=None, padding="max_length", truncation=True):
        if isinstance(text, str):
            return np.asarray(
                self.encode(text, max_length, padding, truncation), dtype=np.int32
            )
        return np.stack(
            [
                np.asarray(self.encode(t, max_length, padding, truncation), dtype=np.int32)
                for t in text
            ]
        )

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        """Byte-decode BPE segments, splicing added tokens verbatim."""
        rev_added = {v: k for k, v in self.added_tokens.items()}
        parts: List[str] = []
        buf: List[str] = []

        def flush():
            if buf:
                seg = bytearray(
                    [self.byte_decoder[c] for c in "".join(buf) if c in self.byte_decoder]
                ).decode("utf-8", errors="replace")
                parts.append(seg.replace("</w>", " "))
                buf.clear()

        for i in ids:
            i = int(i)
            if i in rev_added:
                flush()
                parts.append(rev_added[i] + " ")
                continue
            t = self.decoder.get(i, "")
            if skip_special_tokens and t in (self.bos_token, self.eos_token, self.pad_token):
                continue
            buf.append(t)
        flush()
        return "".join(parts).strip()
