"""The port's `utils/summary.py` and `utils/logging.trace` against the JAX
package's.

- `param_counts` / `summarize` give JAX's counts and text on the same
  nested tree of numpy arrays (tests/test_utils.py's tree and a deeper
  one), and the same total on a TINY RGRG carried across by
  `from_jax_params` (the detector an `nn.Module` counted through its
  dotted `named_parameters`, BatchNorm statistics being buffers in the port
  and `batch_stats` in JAX).
- `trace(log_dir)` writes a Chrome trace of the block on the CPU and is a
  no-op for None.
"""

import json

import numpy as np
import jax
import pytest
import torch

from rgrg_tpu.models.full_model import RGRG as JRGRG
from rgrg_tpu.utils.summary import param_counts as j_param_counts, summarize as j_summarize

from rgrg_tpu_torch.core.convert import from_jax_params
from rgrg_tpu_torch.utils.logging import trace
from rgrg_tpu_torch.utils.summary import param_counts, summarize

from tests.test_torch_pipeline import configs

TREES = [
    {"a": {"w": np.zeros((3, 4)), "b": np.zeros(4)}, "c": {"d": {"w": np.zeros(7)}}},
    {"z": {"1": np.zeros((2, 5)), "0": {"k": np.zeros((3, 3, 2)), "s": np.zeros(())}},
     "a": {"x": {"y": {"q": np.zeros((11,))}}, "b": np.zeros((1, 1))},
     "m": {"b": np.zeros(2), "a": np.zeros(9)}},
]


@pytest.mark.parametrize("depth", [1, 2, 3, 5])
@pytest.mark.parametrize("tree", range(len(TREES)))
def test_param_counts_and_summary_match_jax(tree, depth):
    t = TREES[tree]
    assert param_counts(t, depth) == j_param_counts(t, depth)
    assert list(param_counts(t, depth)) == list(j_param_counts(t, depth))
    assert summarize(t, depth) == j_summarize(t, depth)
    as_tensors = jax.tree.map(torch.from_numpy, t)
    assert summarize(as_tensors, depth) == j_summarize(t, depth)


def test_summary_counts_the_first_tree_as_jax_test_does():
    assert param_counts(TREES[0], depth=1) == {"a": 16, "c": 7}
    text = summarize(TREES[0])
    assert "TOTAL" in text and "23" in text


def test_totals_agree_on_a_tiny_rgrg():
    jcfg, tcfg = configs()
    jp = jax.tree.map(np.asarray, jax.jit(JRGRG(jcfg).init)(jax.random.PRNGKey(0)))
    tp = from_jax_params(jp, tcfg, "cpu")
    jax_params = {"detector": jp["detector"]["params"], "decoder": jp["decoder"]}
    total = sum(param_counts(tp).values())
    assert total == sum(j_param_counts(jax_params).values())
    assert total == (sum(p.numel() for p in tp["detector"].parameters())
                     + sum(t.numel() for t in jax.tree.leaves(tp["decoder"])))
    assert summarize(tp).splitlines()[-1] == j_summarize(jax_params).splitlines()[-1]
    groups = param_counts(tp, depth=2)
    assert "detector/backbone" in groups and any(k.startswith("decoder/") for k in groups)
    # the JAX tree's BatchNorm statistics are the port's buffers, not counted
    stats = sum(j_param_counts({"s": jp["detector"]["batch_stats"]}).values())
    assert stats == sum(b.numel() for n, b in tp["detector"].named_buffers()
                        if n.endswith(("running_mean", "running_var")))


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    with trace(None):
        pass
    assert list(log_dir.iterdir()) == files
