"""The program's tokenizer over the benchmark's vocabulary
(`reference/vocab.py`)."""

from __future__ import annotations

from typing import Dict, Iterable

from port_bench.reference.vocab import word


def tokenizer(cfg: Dict, encodes: Iterable[int] = ()):
    """A GPT-2 tokenizer of the configuration's vocabulary, with the
    byte-pair merges that build each word of `encodes` from its bytes, so
    that the program's BPE encodes ' ' + word(i) as the one id i."""
    from rgrg_tpu_torch.text.tokenizer import ENDOFTEXT, GPT2Tokenizer
    d = cfg["decoder"]
    enc = {"Ġ" + word(i): i for i in range(d["vocab_size"]) if i != d["eos_token_id"]}
    enc[ENDOFTEXT] = d["eos_token_id"]
    merges = {}
    for i in encodes:
        piece = "Ġ"
        for ch in word(i):
            merges[(piece, ch)] = None
            piece += ch
    return GPT2Tokenizer(enc, list(merges))
