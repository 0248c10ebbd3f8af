"""The port's CheXbert fine-tuning (eval/chexbert_train.py) against the JAX
package's, on the CPU.

A random 2-layer HF BertModel plus 14 random linear heads, converted by
each package's convert_chexbert: the loss within 1e-5 (two libraries' f32
encoders), three train_chexbert steps at the reference's lr 2e-5 with
losses within 1e-5 and every parameter within 1e-6 of JAX's (a step moves
a parameter by ~lr = 2e-5, so 1e-6 is 5% of one step). torch.optim.Adam
against optax.adam on the same gradients (both compute lr * m_hat /
(sqrt(v_hat) + 1e-8), in another float order): every parameter within
one float32 ulp of optax's per step. labeler_metrics equals JAX's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from rgrg_tpu.eval import chexbert as jchex
from rgrg_tpu.eval import chexbert_train as jtrain

from rgrg_tpu_torch.eval.chexbert import BertConfig, convert_chexbert
from rgrg_tpu_torch.eval.chexbert_train import (chexbert_loss, labeler_metrics, parameters,
                                                train_chexbert)

HF = dict(vocab_size=40, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
          intermediate_size=64, max_position_embeddings=24)
CFG = dict(vocab_size=40, hidden=32, layers=2, heads=2, intermediate=64, max_positions=24)


@pytest.fixture(scope="module")
def setup():
    from transformers import BertConfig as HFConfig, BertModel
    torch.manual_seed(0)
    hf = BertModel(HFConfig(**HF))
    sd = {f"bert.{k}": v.detach().numpy() for k, v in hf.state_dict().items()}
    rng = np.random.default_rng(0)
    for j in range(14):
        n = 2 if j == 13 else 4
        sd[f"linear_heads.{j}.weight"] = rng.normal(0, 0.1, (n, 32)).astype(np.float32)
        sd[f"linear_heads.{j}.bias"] = rng.normal(0, 0.1, n).astype(np.float32)
    ids = rng.integers(0, 40, (6, 12))
    mask = (np.arange(12)[None] < rng.integers(4, 13, (6, 1))).astype(np.float32)
    labels = np.concatenate([rng.integers(0, 4, (13, 6)), rng.integers(0, 2, (1, 6))])
    return sd, ids, mask, labels


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v.detach() if torch.is_tensor(v) else v)
    return out


def test_chexbert_loss_matches_jax(setup):
    sd, ids, mask, labels = setup
    want = float(jtrain.chexbert_loss(jax.tree.map(jnp.asarray, jchex.convert_chexbert(sd)),
                                      jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(labels),
                                      jchex.BertConfig(**CFG)))
    params = convert_chexbert(sd, device="cpu")
    got = float(chexbert_loss(params, torch.from_numpy(ids), torch.from_numpy(mask),
                              torch.from_numpy(labels), BertConfig(**CFG)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_train_chexbert_three_steps_match_jax(setup):
    sd, ids, mask, labels = setup
    rng = np.random.default_rng(1)
    batches = [(ids, mask, labels)]
    for _ in range(2):
        batches.append((rng.integers(0, 40, ids.shape), mask,
                        np.concatenate([rng.integers(0, 4, (13, 6)),
                                        rng.integers(0, 2, (1, 6))])))
    jparams, jlosses = jtrain.train_chexbert(jax.tree.map(jnp.asarray, jchex.convert_chexbert(sd)),
                                             batches, cfg=jchex.BertConfig(**CFG))
    params, losses = train_chexbert(convert_chexbert(sd, device="cpu"), batches,
                                    cfg=BertConfig(**CFG))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=1e-5)
    got, want, start = _flat(params), _flat(jparams), _flat(convert_chexbert(sd, device="cpu"))
    assert got.keys() == want.keys()
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
        moved += not np.array_equal(got[k], start[k])
    assert moved == len(want)
    assert all(not t.requires_grad for t in parameters(params))


def test_torch_adam_computes_optax_adam():
    """Three steps on the same random gradients (scales 1, 1e-3 and 30):
    torch.optim.Adam's parameters within one float32 ulp of optax.adam's
    (lr 2e-5, eps 1e-8): the two round the same update differently only in
    its last bit."""
    rng = np.random.default_rng(2)
    p0 = rng.normal(0, 1, (64, 8)).astype(np.float32)
    grads = [rng.normal(0, s, p0.shape).astype(np.float32) for s in (1.0, 1e-3, 30.0)]
    opt = optax.adam(2e-5)
    jp, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = torch.from_numpy(p0.copy()).requires_grad_(True)
    topt = torch.optim.Adam([tp], lr=2e-5)
    for n, g in enumerate(grads, start=1):
        u, state = opt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, u)
        tp.grad = torch.from_numpy(g)
        topt.step()
        got, want = tp.detach().numpy(), np.asarray(jp)
        assert (np.abs(got - want) <= n * np.spacing(np.abs(want))).all(), n
    assert np.abs(tp.detach().numpy() - p0).max() > 1e-5


def test_labeler_metrics_match_jax():
    rng = np.random.default_rng(3)
    preds, labels = rng.integers(0, 4, (14, 50)), rng.integers(0, 4, (14, 50))
    assert labeler_metrics(preds, labels) == jtrain.labeler_metrics(preds, labels)
