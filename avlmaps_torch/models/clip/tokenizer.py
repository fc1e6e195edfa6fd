"""CLIP byte-pair-encoding tokenizer.

A copy of ``avlmaps_tpu/models/clip/tokenizer.py`` (pure Python and
numpy; the port keeps its own copy rather than importing the JAX
package).  The byte-level BPE scheme CLIP uses (reference behaviour:
avlmaps/audioclip/utils/simple_tokenizer.py), with OpenAI CLIP's
vocabulary layout:

  ids [0, 256)      single byte tokens
  ids [256, 512)    byte + '</w>' (word-final) tokens
  ids [512, 49406)  learned merges, in merge-rank order
  id  49406 / 49407 <|startoftext|> / <|endoftext|>

The merges file (``bpe_simple_vocab_16e6.txt.gz``) is a *pretrained
artefact*, not code; it ships with real CLIP checkpoints.  When a merges path
is provided (argument or the ``AVLMAPS_TPU_BPE`` environment variable, read
by both packages so one setting tokenises them alike) tokenisation is
id-exact with OpenAI CLIP.  Without it the tokenizer degrades to pure
byte-level segmentation — every emitted id is still a valid CLIP id (byte
tokens occupy fixed positions), so the pipeline runs end-to-end; only the
segmentation (and hence embeddings) differs from a merge-equipped tokenizer.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

VOCAB_SIZE = 49408
CONTEXT_LENGTH = 77
SOT_ID = 49406
EOT_ID = 49407

# CLIP's word-splitting pattern: contractions, letter runs, single digits,
# punctuation runs.  Python's `re` lacks \p classes; [^\W\d_] is the
# letters-only idiom and works for the ASCII prompts this pipeline feeds.
_WORD_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|[^\s\w]+",
    re.IGNORECASE | re.UNICODE,
)


@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2-style reversible byte <-> printable-unicode table."""
    printable = (list(range(ord("!"), ord("~") + 1))
                 + list(range(ord("\xa1"), ord("\xac") + 1))
                 + list(range(ord("\xae"), ord("\xff") + 1)))
    mapping: Dict[int, str] = {b: chr(b) for b in printable}
    shift = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + shift)
            shift += 1
    return mapping


def _clean_text(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text).strip().lower()


class ClipTokenizer:
    """Byte-level BPE with CLIP's vocabulary layout."""

    def __init__(self, merges_path: Optional[str] = None):
        if merges_path is None:
            merges_path = os.environ.get("AVLMAPS_TPU_BPE") or None
        self.byte_encoder = _bytes_to_unicode()
        base = list(self.byte_encoder.values())
        vocab = base + [c + "</w>" for c in base]
        merges: List[Tuple[str, str]] = []
        if merges_path is not None:
            opener = gzip.open if str(merges_path).endswith(".gz") else open
            with opener(merges_path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            # line 0 is a version header; CLIP uses the first 48894 merges
            for line in lines[1:VOCAB_SIZE - 512 - 2 + 1]:
                parts = tuple(line.split())
                if len(parts) == 2:
                    merges.append(parts)  # type: ignore[arg-type]
            vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.merge_rank: Dict[Tuple[str, str], int] = {
            m: i for i, m in enumerate(merges)}
        self.has_merges = bool(merges)
        self._cache: Dict[str, List[int]] = {}

    # -- BPE core ----------------------------------------------------------

    def _bpe(self, token: str) -> List[str]:
        """Greedily apply the lowest-rank merge until none applies."""
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        if not self.has_merges:
            return list(word)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.merge_rank.get(p, 1 << 30))
            if best not in self.merge_rank:
                break
            merged: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == best[0]
                        and word[i + 1] == best[1]):
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        return list(word)

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in _WORD_PAT.findall(_clean_text(text)):
            mapped = "".join(self.byte_encoder[b]
                             for b in token.encode("utf-8"))
            if mapped not in self._cache:
                self._cache[mapped] = [self.encoder[p]
                                       for p in self._bpe(mapped)]
            ids.extend(self._cache[mapped])
        return ids

    def __call__(self, texts: Union[str, Sequence[str]],
                 context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        """Tokenise to a (B, context_length) int32 array with SOT/EOT framing
        and zero padding, truncating long prompts (CLIP semantics)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [SOT_ID] + self.encode(text) + [EOT_ID]
            if len(ids) > context_length:
                ids = ids[:context_length - 1] + [EOT_ID]
            out[i, :len(ids)] = ids
        return out


@functools.lru_cache()
def default_tokenizer() -> ClipTokenizer:
    return ClipTokenizer()


def tokenize(texts, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
    return default_tokenizer()(texts, context_length)
