"""RGRGDataset.rank_batches, the train CLI's rank-local loader, on the CPU:
every rank of worlds 2 and 4 in this process (a thread each; the agreement
on unreadable samples is an exchange among the threads), no model.

The split: 23 rows over cv2-written PNGs whose longest side is the
transforms' image size (128 here, so nothing is resized), three of them
unreadable. In the first epoch's shuffled order those sit at positions 1,
6 and 9, for global batches of 4: position 1 lies in rank 0's rows (at
world 2 the sample at position 2 then moves from rank 1's rows to rank
0's); position 6 moves the second batch's rows onto position 9, which is
found unreadable only then (three agreement rounds). The second epoch reshuffles
them. Held, over two epochs:
  - each rank's batches equal core.mesh.shard_pytree_batch of the
    replicated loader's (batches(workers=2)) bit for bit, the list leaves
    included, also when it builds no batch ahead or two;
  - every rank yields as many batches as the replicated loader;
  - a rank builds its rows plus, for each batch, at most one sample for
    each unreadable sample that lies before its last row (the skips that
    moved into its rows), counted from the split's own order; and at least
    one more where such a skip moved its last row;
  - the replicated loader's batches equal the JAX package's
    RGRGDataset.batches(workers=2) within tests/test_torch_augment.py's
    tolerances.
tests/test_torch_mesh.py runs a split of this module through the train
CLI's ranks over a real gloo launch.
"""

import csv
import json

import numpy as np
import cv2
import pytest

from rgrg_tpu.data import transforms as JT
from rgrg_tpu.data.dataset import RGRGDataset as JDataset, read_split_csv as j_read
from rgrg_tpu.text.tokenizer import GPT2Tokenizer as JTokenizer

from rgrg_tpu_torch.core import mesh
from rgrg_tpu_torch.data import transforms as T
from rgrg_tpu_torch.data.dataset import RGRGDataset, read_split_csv
from rgrg_tpu_torch.text.tokenizer import GPT2Tokenizer

from tests.test_torch_augment import _image_close
from tests.torch_mesh_ranks import rank_local_epochs

SEED = 42            # RGRGDataset's default seed: the order of each epoch
ROWS = 23
UNREADABLE = (1, 6, 9)   # positions in the first epoch's order
BATCH = 4
SIZE = 128
SEQ = 12
LETTERS = "abcde"


def epoch_orders(n, epochs, seed=SEED):
    """The dataset's shuffled order of each epoch (its Generator draws
    nothing else on the per-sample stream)."""
    rng = np.random.default_rng(seed)
    orders = []
    for _ in range(epochs):
        order = np.arange(n)
        rng.shuffle(order)
        orders.append(order)
    return orders


def write_tokenizer(path):
    """A byte-level vocabulary of EOS (id 0) and the split's characters,
    without merges: ids under 10, inside a tiny decoder's vocabulary."""
    from rgrg_tpu_torch.text.tokenizer import ENDOFTEXT
    path.mkdir()
    vocab = [ENDOFTEXT] + list(LETTERS) + ["Ġ", "."]
    (path / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(vocab)}),
                                     encoding="utf-8")
    (path / "merges.txt").write_text("#version: 0.2\n", encoding="utf-8")
    return str(path)


def write_split(dir_path, rows=ROWS, unreadable=UNREADABLE, size=SIZE, seed=0):
    """A split csv in the ETL's schema over PNGs whose longest side is
    `size`; the rows at the first epoch's `unreadable` positions name a
    missing file. Phrases of LETTERS words for ~60% of the regions."""
    rng = np.random.default_rng(seed)
    missing = set(epoch_orders(rows, 1)[0][list(unreadable)].tolist())
    out = []
    for i in range(rows):
        short = int(rng.integers(size * 3 // 4, size + 1))
        h, w = (size, short) if i % 2 else (short, size)
        path = dir_path / f"img{i}.png"
        if i not in missing:
            cv2.imwrite(str(path), rng.integers(0, 256, (h, w), dtype=np.uint8))
        labels = sorted(rng.choice(np.arange(1, 30), 20, replace=False).tolist())
        xy = rng.uniform(0, [w * 0.7, h * 0.7], (20, 2))
        wh = rng.uniform(4, [w * 0.3, h * 0.3], (20, 2))
        boxes = np.concatenate([xy, np.minimum(xy + wh, [w, h])], -1).round(1)
        phrases = [" ".join("".join(rng.choice(list(LETTERS), rng.integers(1, 4)))
                            for _ in range(rng.integers(1, 4))) + "."
                   if rng.uniform() < 0.6 else "" for _ in range(29)]
        out.append({"mimic_image_file_path": str(path), "bbox_coordinates": str(boxes.tolist()),
                    "bbox_labels": str(labels), "bbox_phrases": str(phrases),
                    "bbox_phrase_exists": str([bool(p) for p in phrases]),
                    "bbox_is_abnormal": str([bool(rng.uniform() < 0.3) for _ in phrases]),
                    "reference_report": " ".join(p for p in phrases if p)})
    csv_path = dir_path / "train.csv"
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(out[0]))
        writer.writeheader()
        writer.writerows(out)
    return str(csv_path), sorted(missing)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    d = tmp_path_factory.mktemp("rank_split")
    path, missing = write_split(d)
    return dict(path=path, missing=missing, tok=write_tokenizer(d / "tok"))


def dataset(split):
    return RGRGDataset(read_split_csv(split["path"]), GPT2Tokenizer.from_dir(split["tok"]),
                       train=True, seq_len=SEQ, tcfg=T.TransformConfig(image_size=SIZE))


@pytest.fixture(scope="module")
def replicated(split):
    """The replicated loader's batches (workers=2), two epochs of one
    dataset."""
    ds = dataset(split)
    return [list(ds.batches(BATCH, shuffle=True, workers=2)) for _ in range(2)]


def assert_same_batch(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert repr(got[k]) == repr(w), k


def build_bounds(split, world, epochs=2):
    """Per rank and epoch, the fewest and the most samples it may build:
    its rows, plus per global batch one sample if an unreadable one lies
    between the previous batch's last row and its own last row (the last
    row moved past its first guess), or at most one for each such
    unreadable sample."""
    missing = set(split["missing"])
    per = BATCH // world
    out = [[[0, 0] for _ in range(epochs)] for _ in range(world)]
    for e, order in enumerate(epoch_orders(ROWS, epochs)):
        readable = [p for p, i in enumerate(order) if i not in missing]
        skipped = [p for p, i in enumerate(order) if i in missing]
        prev = -1
        for k in range(len(readable) // BATCH):
            pos = readable[k * BATCH:(k + 1) * BATCH]
            for r in range(world):
                moved = sum(prev < u < pos[(r + 1) * per - 1] for u in skipped)
                out[r][e][0] += per + min(moved, 1)
                out[r][e][1] += per + moved
            prev = pos[-1]
    return out


def test_split_layout(split, replicated):
    """Three unreadable rows; the first epoch's order puts them at
    UNREADABLE; 20 readable rows give 5 batches of 4 an epoch, so fewer
    than a batch's positions are left after the last (no epoch ends on a
    partial window)."""
    assert len(split["missing"]) == 3 < BATCH
    order = epoch_orders(ROWS, 2)
    assert sorted(np.flatnonzero(np.isin(order[0], split["missing"])).tolist()) == list(UNREADABLE)
    assert not np.array_equal(order[0], order[1])
    assert [len(e) for e in replicated] == [5, 5]


@pytest.mark.parametrize("world", [2, 4])
def test_rank_batches_are_the_replicated_rows(split, replicated, world):
    ranks = rank_local_epochs(lambda: dataset(split), BATCH, world, epochs=2, workers=2,
                              ahead=1)
    bounds = build_bounds(split, world)
    for r, epochs in enumerate(ranks):
        m = mesh.Mesh(world, r)
        for e, (batches, stats) in enumerate(epochs):
            assert len(batches) == len(replicated[e])
            for got, want in zip(batches, replicated[e]):
                assert_same_batch(got, mesh.shard_pytree_batch(want, m))
            assert stats.rows == len(batches) * BATCH // world
            low, high = bounds[r][e]
            assert low <= stats.built <= high, (r, e, stats, low, high)
            assert stats.unreadable == 3
    first = [epochs[0][1] for epochs in ranks]
    # one agreement a batch, one more for position 1 and two more for the
    # second batch's cascade (positions 6, 9); the same on every rank
    assert len({s.rounds for s in first}) == 1 and first[0].rounds == 5 + 1 + 2
    # skips moved some rank's rows in the first epoch
    assert max(b[0][0] for b in bounds) > len(replicated[0]) * BATCH // world


@pytest.mark.parametrize("ahead", [0, 2])
def test_rank_batches_with_other_lookahead(split, replicated, ahead):
    """Building no batch ahead, or two (which may build samples a skip
    then moves away), gives the same rows at world 2."""
    ranks = rank_local_epochs(lambda: dataset(split), BATCH, 2, epochs=2, workers=1,
                              ahead=ahead)
    for r, epochs in enumerate(ranks):
        for e, (batches, stats) in enumerate(epochs):
            assert len(batches) == len(replicated[e])
            for got, want in zip(batches, replicated[e]):
                assert_same_batch(got, mesh.shard_pytree_batch(want, mesh.Mesh(2, r)))
            assert stats.built >= stats.rows


def test_rank_batches_reject_a_batch_that_does_not_divide(split):
    with pytest.raises(ValueError, match="does not divide"):
        next(dataset(split).rank_batches(BATCH, 0, 3, lambda failed: [failed]))


def test_replicated_rows_match_jax(split, replicated):
    jds = JDataset(j_read(split["path"]), JTokenizer.from_dir(split["tok"]), train=True,
                   seq_len=SEQ, tcfg=JT.TransformConfig(image_size=SIZE))
    for e in range(2):
        want = list(jds.batches(BATCH, shuffle=True, workers=2))
        assert len(want) == len(replicated[e])
        for g, w in zip(replicated[e], want):
            assert g.keys() == w.keys()
            for k in w:
                if k == "images":
                    for gi, wi in zip(g[k], w[k]):
                        _image_close(gi, wi)
                elif k == "gt_boxes":
                    np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5)
                elif isinstance(w[k], np.ndarray):
                    assert g[k].dtype == w[k].dtype, k
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                else:
                    assert g[k] == w[k], k


def test_a_rank_outside_the_mesh_does_not_train():
    """train.loop.train refuses a mesh the rank is outside of (the CLI's
    rank returns before loading); a process alone's host mesh is its mesh
    of one."""
    from rgrg_tpu_torch.train import loop
    with pytest.raises(ValueError, match="outside the 1-rank mesh"):
        loop.train(None, None, None, "unused", mesh=mesh.Mesh(1, 1))
    alone = mesh.make_mesh(batch_size=BATCH)
    assert mesh.host_mesh(alone) is alone and alone.group is None
