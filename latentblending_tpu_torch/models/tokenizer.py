"""CLIP byte-pair-encoding tokenizer, implemented from scratch.

The reference gets tokenization for free inside pipe.encode_prompt
(reference diffusers_holder.py:81). We own it: a checkpoint-driven BPE
identical in behavior to the CLIP tokenizer (lowercase, whitespace cleanup,
CLIP's token regex, merges-ranked BPE over a byte→unicode alphabet, word
suffix '</w>', bos/eos wrap, pad to 77).

SDXL specifics: tokenizer_1 pads with <|endoftext|> (id 49407); tokenizer_2
pads with '!' (id 0). Both truncate to 75 content tokens.

Vocab/merges load from a HF snapshot dir (tokenizer/vocab.json +
merges.txt). For weightless environments a deterministic HashTokenizer
stands in (stable ids, correct shape/eos contract) so the full pipeline
stays drivable.
"""
from __future__ import annotations

import functools
import gzip
import json
import os
import re
import unicodedata

import numpy as np

# `regex` (for CLIP's \p{L}/\p{N} classes) is imported only where the BPE
# tokenizer needs it: hosts without the package can still run the
# HashTokenizer path.
_TOKEN_PATTERN_SRC = r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""


@functools.lru_cache()
def _token_pattern():
    import regex

    return regex.compile(_TOKEN_PATTERN_SRC, regex.IGNORECASE)


@functools.lru_cache()
def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2/CLIP reversible byte→unicode mapping."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _whitespace_clean(text: str) -> str:
    # stdlib `re` matches Unicode whitespace for \s on str patterns; it
    # differs from `regex` only on the \x1c-\x1f separator controls
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    """BPE tokenizer over a vocab.json + merges.txt pair."""

    def __init__(
        self,
        vocab: dict[str, int],
        merges: list[tuple[str, str]],
        bos_token_id: int = 49406,
        eos_token_id: int = 49407,
        pad_token_id: int = 49407,
        model_max_length: int = 77,
    ):
        self.encoder = vocab
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id
        # HF CLIPTokenizer maps unknown pieces to unk_token == <|endoftext|>
        self.unk_token_id = eos_token_id
        self.model_max_length = model_max_length
        self._cache: dict[str, list[str]] = {}

    # --- constructors ------------------------------------------------------

    @classmethod
    def from_dir(cls, tokenizer_dir: str, **kw) -> "CLIPTokenizer":
        with open(os.path.join(tokenizer_dir, "vocab.json")) as f:
            vocab = json.load(f)
        merges_path = os.path.join(tokenizer_dir, "merges.txt")
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt") as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines if l and not l.startswith("#version")]
        cfg_path = os.path.join(tokenizer_dir, "special_tokens_map.json")
        pad = kw.pop("pad_token_id", None)
        if pad is None and os.path.exists(cfg_path):
            with open(cfg_path) as f:
                special = json.load(f)
            pad_tok = special.get("pad_token")
            if isinstance(pad_tok, dict):
                pad_tok = pad_tok.get("content")
            if pad_tok is not None:
                pad = vocab.get(pad_tok + "</w>", vocab.get(pad_tok))
        if pad is None:
            pad = vocab.get("<|endoftext|>")
        return cls(
            vocab,
            merges,
            bos_token_id=vocab.get("<|startoftext|>", 49406),
            eos_token_id=vocab.get("<|endoftext|>", 49407),
            pad_token_id=pad,
            **kw,
        )

    # --- BPE ---------------------------------------------------------------

    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        if not pairs:
            return [token + "</w>"]
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
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
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        out = list(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> list[int]:
        # normalization matches transformers' CLIPTokenizerFast (NFC →
        # whitespace collapse → lowercase). NOTE: openai/CLIP additionally
        # runs ftfy.fix_text + html.unescape×2; the HF tokenizers the
        # reference actually uses (via diffusers pipe.encode_prompt,
        # dh:81) do NOT — differential-tested in test_tokenizer_hf_diff.py.
        text = _whitespace_clean(unicodedata.normalize("NFC", text)).lower()
        ids: list[int] = []
        for token in _token_pattern().findall(text):
            # special tokens map straight to their ids (HF added-token
            # machinery); they never pass through byte-BPE
            if token == "<|startoftext|>":
                ids.append(self.bos_token_id)
                continue
            if token == "<|endoftext|>":
                ids.append(self.eos_token_id)
                continue
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            for piece in self._bpe(token):
                # unknown pieces map to unk (HF CLIPTokenizer convention);
                # with a full byte alphabet in the vocab this never triggers
                ids.append(self.encoder.get(piece, self.unk_token_id))
        return ids

    def __call__(self, text: str | list[str]) -> np.ndarray:
        """Returns padded int32 ids [B, 77] with bos/eos, CLIP truncation."""
        texts = [text] if isinstance(text, str) else list(text)
        L = self.model_max_length
        out = np.full((len(texts), L), self.pad_token_id, np.int32)
        for i, t in enumerate(texts):
            ids = self.tokenize(t)[: L - 2]
            row = [self.bos_token_id] + ids + [self.eos_token_id]
            out[i, : len(row)] = row
        return out


class HashTokenizer:
    """Deterministic stand-in when no vocab files are available (weightless
    bench/test environments): stable per-word ids, correct bos/eos/pad/shape
    contract. NOT CLIP-compatible — real deployments load CLIPTokenizer."""

    def __init__(
        self,
        vocab_size: int = 49408,
        bos_token_id: int = 49406,
        eos_token_id: int = 49407,
        pad_token_id: int = 49407,
        model_max_length: int = 77,
    ):
        self.vocab_size = vocab_size
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id
        self.model_max_length = model_max_length

    def tokenize(self, text: str) -> list[int]:
        import hashlib

        words = _whitespace_clean(text).lower().split()
        return [
            int.from_bytes(hashlib.sha256(w.encode()).digest()[:4], "little") % (self.vocab_size - 3)
            for w in words
        ]

    def __call__(self, text: str | list[str]) -> np.ndarray:
        texts = [text] if isinstance(text, str) else list(text)
        L = self.model_max_length
        out = np.full((len(texts), L), self.pad_token_id, np.int32)
        for i, t in enumerate(texts):
            ids = self.tokenize(t)[: L - 2]
            row = [self.bos_token_id] + ids + [self.eos_token_id]
            out[i, : len(row)] = row
        return out
