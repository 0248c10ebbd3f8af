"""Functions the data-parallel tests run on each rank (core/mesh.launch).

A spawned rank imports this module by name, so it imports only numpy,
torch and rgrg_tpu_torch: no JAX. Each function takes the rank first and
returns host objects: digests from every rank, tensors from rank 0 alone
(the tests compare them with world 1's); the tests call the same
functions in their own process for world 1 (make_mesh() outside a launch
is a mesh of one).
"""

from __future__ import annotations

import copy
import hashlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rgrg_tpu_torch.core import mesh as mesh_lib


def tasks(rank: int, todo: Sequence[Tuple[str, Callable, tuple]]) -> Dict[str, Any]:
    """Run every (name, function, args) of `todo` in turn: one launch for
    all of a test module's rank work."""
    return {name: fn(rank, *args) for name, fn, args in todo}


def digest(arrays: Sequence[np.ndarray]) -> str:
    """One hash of the arrays' bytes: ranks compare tensors bit for bit
    without sending them."""
    h = hashlib.blake2b()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def batch_digest(batch: Dict[str, Any]) -> str:
    """One hash of a batch dict: every leaf's name, and an array's dtype,
    shape and bytes or another leaf's repr (the list leaves)."""
    h = hashlib.blake2b()
    for k in sorted(batch):
        v = batch[k]
        h.update(k.encode())
        if isinstance(v, np.ndarray):
            h.update(f"{v.dtype}{v.shape}".encode())
            h.update(np.ascontiguousarray(v).tobytes())
        else:
            h.update(repr(v).encode())
    return h.hexdigest()


def rank_local_epochs(make_dataset: Callable[[], Any], batch_size: int, world: int,
                      epochs: int = 2, workers: int = 2, ahead: int = 1) -> List[List[Any]]:
    """Every rank of `world` in this process, a thread each with its own
    dataset (make_dataset()), iterating RGRGDataset.rank_batches (shuffled)
    for `epochs` epochs; the agreement on unreadable samples is an
    exchange among the threads. Per rank, per epoch: (batches,
    RankLoadStats)."""
    from rgrg_tpu_torch.data.dataset import RankLoadStats
    slots: List[Any] = [None] * world
    barrier = threading.Barrier(world, timeout=120)

    def run(rank: int):
        def exchange(failed: List[int]) -> List[List[int]]:
            slots[rank] = list(failed)
            barrier.wait()
            out = list(slots)
            barrier.wait()   # every rank has read the slots before they change
            return out

        ds = make_dataset()
        out = []
        try:
            for _ in range(epochs):
                stats = RankLoadStats()
                out.append((list(ds.rank_batches(batch_size, rank, world, exchange,
                                                 shuffle=True, workers=workers, ahead=ahead,
                                                 stats=stats)), stats))
        except BaseException:
            barrier.abort()   # the other ranks stop waiting for this one
            raise
        return out

    with ThreadPoolExecutor(world) as ex:
        futures = [ex.submit(run, r) for r in range(world)]
        return [f.result() for f in futures]


def train_cli(rank: int, argv: List[str], cfg) -> Dict[str, Any]:
    """The train CLI on `argv`: in a process group of more than one rank,
    rank `rank` of its rank path (`_train_rank`), else `main` in this
    process. The digest of each batch the train step took (this rank's
    rows), and the final state's digest and (rank 0) tensors."""
    import rgrg_tpu_torch.train.__main__ as cli
    from rgrg_tpu_torch.train import trainer

    batches: List[str] = []
    states: List[Any] = []
    make_step, train = trainer.make_train_step, cli._train

    def recording(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, batch, rng):
            batches.append(batch_digest(batch))
            return step(state, batch, rng)
        return run

    def kept(*a, **kw):
        states.append(train(*a, **kw))
        return states[-1]

    trainer.make_train_step, cli._train = recording, kept
    try:
        if mesh_lib.visible_devices() > 1:
            cli._train_rank(rank, cli.build_parser().parse_args(argv), cfg)
        else:
            cli.main(argv, cfg=cfg)
    finally:
        trainer.make_train_step, cli._train = make_step, train
    return dict(batches=batches, step=states[0].step, **_trained(rank, states[0]))


def _trained(rank: int, state, grads: Optional[List[np.ndarray]] = None):
    """The trained tensors' digest, and on rank 0 the tensors (and
    `grads`)."""
    params = [t.detach().numpy() for t in state.opt_state.tensors]
    out = {"digest": digest(params)}
    if rank == 0:
        out.update(params=[p.copy() for p in params], grads=grads)
    return out


def serve(rank: int, params, cfg, images: Sequence[np.ndarray],
          cases: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """generate_reports_pipelined(mesh=make_mesh()) for each case's kwargs:
    the reports, selected regions and CascadeStats snapshot."""
    from rgrg_tpu_torch.inference import ReportGenerator
    from rgrg_tpu_torch.serving import CascadeStats, generate_reports_pipelined
    from rgrg_tpu_torch.text.tokenizer import GPT2Tokenizer

    mesh = mesh_lib.make_mesh()
    gen = ReportGenerator(params, GPT2Tokenizer.dummy(), cfg=cfg)
    mesh_lib.replicate_pytree(gen.params, mesh)   # once, as serve.py does after loading
    out = []
    for kw in cases:
        stats = CascadeStats()
        reports = [r for chunk in generate_reports_pipelined(
            gen, images, mesh=mesh, cascade_stats=stats, **kw) for r in chunk]
        out.append({"reports": [r.report for r in reports],
                    "selected": np.stack([r.selected_regions for r in reports]),
                    "stats": stats.snapshot()})
    return out


def helpers(rank: int) -> Dict[str, Any]:
    """make_mesh past the ranks and clamped to a batch of 3;
    shard_pytree_batch of a batch; replicate_pytree of params that differ
    per rank before (an f32 tensor, a bf16 module, a non-contiguous view)."""
    try:
        mesh_lib.make_mesh(3)
        too_many = None
    except ValueError as e:
        too_many = str(e)
    clamped = mesh_lib.make_mesh(batch_size=3)
    mesh = mesh_lib.make_mesh()
    batch = {"x": np.arange(8).reshape(4, 2), "t": torch.arange(4) * 10, "name": "b"}
    shard = mesh_lib.shard_pytree_batch(batch, mesh)
    gen = torch.Generator().manual_seed(100 + rank)
    params = {"a": torch.randn(3, generator=gen),
              "m": torch.nn.Linear(2, 2).to(torch.bfloat16),
              "l": [torch.randn(2, 2, generator=gen).t()]}
    before = params["a"].clone()
    mesh_lib.replicate_pytree(params, mesh)
    return {"too_many": too_many, "clamped": (clamped.size, clamped.member),
            "size": mesh.size, "rank": mesh.rank,
            "x": shard["x"], "t": shard["t"].numpy(), "name": shard["name"],
            "before": before.numpy(), "a": params["a"].numpy(),
            "m": params["m"].weight.float().detach().numpy(), "l": params["l"][0].numpy()}


def fail_on_rank_1(rank: int) -> None:
    """Rank 1 raises while rank 0 waits in a collective."""
    mesh = mesh_lib.make_mesh()
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    mesh_lib.barrier(mesh)


def serve_cli(rank: int, argv: List[str], cfg) -> None:
    """The serve CLI on `argv`: in this process, or with `--data-parallel
    N` as rank `rank` of the N ranks that `python -m rgrg_tpu_torch.serve`
    starts (rank 0 writes `--output`)."""
    from rgrg_tpu_torch import serve
    args = serve.build_parser().parse_args(argv)
    if args.data_parallel is None:
        serve.main(argv, cfg=cfg)
    else:
        serve._serve_rank(rank, args, cfg)


def train_step(rank: int, params, cfg, tcfg, batch: Dict[str, np.ndarray], draws,
               lm_budget: int) -> Dict[str, Any]:
    """One stage-3 mini-step of make_train_step(mesh=make_mesh()) (an AdamW
    update at accumulation 1) on this rank's rows of the global `batch`,
    with the global sampling draws `draws` replayed: the losses, the
    BatchNorm running statistics, the trained tensors' digest, and (rank
    0) the all-reduced gradient AdamW stepped on and the tensors after the
    update."""
    from rgrg_tpu_torch.models.full_model import RGRG
    from rgrg_tpu_torch.train import trainer

    mesh = mesh_lib.make_mesh()
    state = trainer.TrainState(params, trainer.make_optimizer(params, tcfg, 3), 0)
    opt = state.opt_state
    grads: List[np.ndarray] = []
    adamw_step = opt.adamw.step

    def recording_step():
        if rank == 0:
            grads.extend(t.grad.numpy().copy() for t in opt.tensors)
        return adamw_step()
    opt.adamw.step = recording_step
    step = trainer.make_train_step(RGRG(cfg), tcfg, 3, lm_budget, mesh=mesh)
    state, losses = step(state, mesh_lib.shard_pytree_batch(batch, mesh), iter(draws))
    out = {"losses": {k: float(v) for k, v in losses.items()},
           "stats": {k: v.numpy().copy() for k, v in params["detector"].named_buffers()
                     if "running" in k}}
    return dict(out, **_trained(rank, state, grads))


def backbone_grads(rank: int, backbone, images: np.ndarray, weights: np.ndarray,
                   dtype=torch.float64) -> Dict[str, Any]:
    """The parameter gradients of sum(backbone(images) * weights) over the
    global batch, BatchNorm in train mode under the mesh, in `dtype` (on a
    copy of `backbone`), all-reduced: their digest, and (rank 0) the
    gradients."""
    mesh = mesh_lib.make_mesh()
    backbone = copy.deepcopy(backbone).to(dtype).train()
    backbone.dtype = dtype
    x = torch.from_numpy(mesh_lib.shard_pytree_batch(images, mesh)).to(dtype)
    w = torch.from_numpy(mesh_lib.shard_pytree_batch(weights, mesh)).to(dtype)
    with mesh_lib.active(mesh):
        (backbone(x) * w).sum().backward()
    grads = {n: mesh_lib.global_sum(p.grad, mesh).numpy() for n, p in backbone.named_parameters()}
    return {"digest": digest(list(grads.values())), "grads": grads if rank == 0 else None}


def draws_and_dropout(rank: int, decoder, cfg, inputs: Dict[str, np.ndarray],
                      budget: int) -> Dict[str, Any]:
    """Under the mesh: assign.uniform from a Generator seeded 7 at this
    rank's shape [2, 5], and lm_loss_selected with dropout (default
    generator seeded 3) on this rank's rows of `inputs` (a copy of
    `decoder`), with the gradient of its region features."""
    from rgrg_tpu_torch.train import assign, losses

    mesh = mesh_lib.make_mesh()
    decoder = copy.deepcopy(decoder)
    t = {k: torch.from_numpy(v) for k, v in mesh_lib.shard_pytree_batch(inputs, mesh).items()}
    feats = t["region_features"].requires_grad_(True)
    torch.manual_seed(3)
    with mesh_lib.active(mesh):
        keys = assign.uniform(torch.Generator().manual_seed(7), (inputs["seq_valid"].shape[0]
                                                                // mesh.size, 5), "cpu")
        loss = losses.lm_loss_selected(decoder, t["input_ids"], t["attention_mask"], feats,
                                       t["seq_valid"], cfg, budget, dropout=True)
        total = mesh_lib.global_sum(loss.detach(), mesh)
        loss.backward()
    return {"keys": keys.numpy(), "loss": float(total), "feats_grad": feats.grad.numpy()}


def train_loop(rank: int, cfg, batches: Sequence[Dict[str, np.ndarray]], run_dir: str,
               lm_budget: int) -> Dict[str, Any]:
    """train.loop.train over `batches` to step len(batches) (`last`
    written), then resumed from `last` over them again: per run the step,
    the trained tensors' digest and (rank 0) the tensors."""
    from rgrg_tpu_torch.models.full_model import RGRG
    from rgrg_tpu_torch.train import loop

    model = RGRG(cfg.model)
    n = len(batches)
    out = {}
    for name, steps, resume in (("run", n, None), ("resumed", 2 * n, f"{run_dir}/run/last")):
        state = loop.train(model, cfg, lambda: iter(batches), f"{run_dir}/{name}", stage=3,
                           lm_budget=lm_budget, max_steps=steps, resume_from=resume,
                           device="cpu")
        out[name] = dict(step=state.step, **_trained(rank, state))
    return out
