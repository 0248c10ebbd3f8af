"""Dataset statistics the evaluation reads (the port's own copy).

`load_cider_doc_frequencies` reads the CIDEr-D document frequencies of the
validation reference reports that the JAX package's
`compute_cider_doc_frequencies` caches (scripts/compute_cider_df.py): a
gzip'd pickle of {"df": {ngram tuple: count}, "log_num_docs": float}, the
counterpart of the reference's mimic-cxr-document-frequency.bin.gz. Only
load files that tool wrote: unpickling runs code.
"""

from __future__ import annotations

import gzip
import pickle


def load_cider_doc_frequencies(path: str):
    with gzip.open(path, "rb") as f:
        obj = pickle.load(f)
    return obj["df"], obj["log_num_docs"]
