"""Pipelined batch serving: host work overlapped with device compute.

A three-stage pipeline over batches of images:

  stage P (thread): image load + preprocessing of batches i+1 and i+2 (raw
                    uint8 upload for the device resize when a batch shares
                    one shape, the host pipeline otherwise)
  stage D (main):   detector + budgeted decode of batch i on the device
  stage T (thread): copy to the host, tokenizer decode and report assembly
                    of batch i-1

CUDA launches return before the card finishes, so stage D queues batch i's
work and stage T's copies wait for it off the main thread. The decode is
the JAX package's serving decode (rgrg_tpu/serving.py), step for step: the
length-bucket cascade with its closure telemetry and bail-out
(CascadeStats), the speculative fused dispatch at a predicted row budget
with its validation read and budget-miss re-decode, the synchronous split
path with its detect lookahead, caller-selected regions, and weight-only
int8 decoder weights (`weights_int8`, kernel K4 for the "pallas" layout).

Data-parallel serving (`mesh=`, core/mesh.py) runs one process per card:
every rank preprocesses, detects and decodes only its contiguous shard of
each batch (the final partial batch padded to batch_size, pad rows
selecting nothing), then the ranks exchange their reports as host
objects, so that every rank yields the whole batch's reports in image
order; CascadeStats count over all ranks. Each rank compacts and budgets
its own rows: the JAX package's row-sharding constraint on the compacted
decode and its rounding of the row budget to a multiple of mesh.size
(rgrg_tpu/models/full_model.py) have no counterpart here, since no decode
spans two devices. The ranks serve the params they were given, which the
caller replicates once (core.mesh.replicate_pytree, as serve.py does
after loading), not on every call.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from rgrg_tpu_torch.core import constants as C
from rgrg_tpu_torch.core import mesh as mesh_lib
from rgrg_tpu_torch.inference import GeneratedReport, ReportGenerator
from rgrg_tpu_torch.models import gpt2
from rgrg_tpu_torch.text.report import assemble_report
from rgrg_tpu_torch.utils.logging import span


@dataclasses.dataclass
class CascadeStats:
    """Closure telemetry and bail-out policy of the length-bucket cascade.

    The cascade pays off when most region sentences fit the first bucket
    (~95% in the reference's data); when nothing closes at rung 1 the
    rung-1 decode is pure overhead (measured 1.37x slower than a direct
    full-length decode on the TPU). This records the rung-1 closure rate
    over batches; once `min_rows` rows were seen and closure is below
    `threshold`, `should_bail()` turns True and the serving loop decodes
    later batches at max_length directly (threshold 0 never bails).

    A selected row is closed at rung 1 iff it does not re-decode at rung 2:
    greedy, its EOS fit inside the bucket; beam, its search closed and the
    best hypothesis fit."""
    threshold: float = 0.5
    min_rows: int = 64
    rows_selected: int = 0
    rows_closed_rung1: int = 0
    batches: int = 0
    bailed_out: bool = False
    rung_rows: Dict[int, int] = dataclasses.field(default_factory=dict)

    def record_rung1(self, selected: int, remaining: int) -> None:
        self.batches += 1
        self.rows_selected += int(selected)
        self.rows_closed_rung1 += int(selected) - int(remaining)

    def record_rung(self, bucket: int, entering: int) -> None:
        """Rows entering the decode at cache size `bucket`."""
        self.rung_rows[int(bucket)] = self.rung_rows.get(int(bucket), 0) + int(entering)

    def closure_rate(self) -> Optional[float]:
        if not self.rows_selected:
            return None
        return self.rows_closed_rung1 / self.rows_selected

    def should_bail(self) -> bool:
        rate = self.closure_rate()
        return (not self.bailed_out and rate is not None
                and self.rows_selected >= self.min_rows and rate < self.threshold)

    def counts(self) -> Dict:
        return {"rows_selected": self.rows_selected, "batches": self.batches,
                "rows_closed_rung1": self.rows_closed_rung1, "rung_rows": dict(self.rung_rows)}

    def set_sum(self, parts: Sequence[Dict]) -> None:
        """Counts = the sum of the ranks' `counts()` (batches: each rank
        sees every batch)."""
        self.rows_selected = sum(p["rows_selected"] for p in parts)
        self.rows_closed_rung1 = sum(p["rows_closed_rung1"] for p in parts)
        self.batches = max(p["batches"] for p in parts)
        self.rung_rows = {}
        for p in parts:
            for k, v in p["rung_rows"].items():
                self.rung_rows[k] = self.rung_rows.get(k, 0) + v

    def snapshot(self) -> Dict:
        return {
            "batches": self.batches,
            "rows_selected": self.rows_selected,
            "rows_closed_rung1": self.rows_closed_rung1,
            "rung1_closure_rate": self.closure_rate(),
            "rows_entering_rung": dict(sorted(self.rung_rows.items())),
            "bailed_out": self.bailed_out,
            "threshold": self.threshold,
        }


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.cpu().numpy()


def _postprocess(gen: ReportGenerator, device_out, n_images: int,
                 batch_id: Optional[int] = None) -> List[GeneratedReport]:
    """One batch's outputs -> reports (runs on the post thread: its copies
    wait for the batch's device work there, not on the main thread)."""
    with span("serve.postprocess", batch_id):
        with span("post.copy"):
            out = _to_host(device_out)
        ids = out["output_ids"]
        results = []
        for b in range(n_images):
            sel = out["decoded_mask"][b]
            region_sents = {}
            ordered = []
            for r in range(C.NUM_REGIONS):
                if sel[r]:
                    text = gen.tokenizer.decode(ids[b, r], skip_special_tokens=True)
                    region_sents[C.REGION_NAMES[r]] = text
                    ordered.append(text)
            results.append(GeneratedReport(
                report=assemble_report(ordered, gen.similarity_fn, gen.threshold),
                region_sentences=region_sents,
                selected_regions=out["selected_regions"][b],
                class_detected=out["class_detected"][b],
                top_region_boxes=out["detections"]["top_region_boxes"][b]))
        return results


def _kv_dtype(kv_cache_dtype) -> Optional[torch.dtype]:
    if kv_cache_dtype is None:
        return None
    if isinstance(kv_cache_dtype, torch.dtype):
        if kv_cache_dtype == torch.int8 or kv_cache_dtype.is_floating_point:
            return kv_cache_dtype
    elif isinstance(kv_cache_dtype, (str, np.dtype)) and kv_cache_dtype == "int8":
        return torch.int8  # the string and np.dtype("int8")
    raise ValueError(f"kv_cache_dtype must be 'int8', torch.int8, None or a torch "
                     f"float dtype; got {kv_cache_dtype!r}")


def generate_reports_pipelined(gen: ReportGenerator,
                               images: Sequence[Union[str, np.ndarray]],
                               batch_size: int = 16,
                               num_beams: int = 1,
                               max_length: int = 300,
                               early_stopping: bool = True,
                               selection_override: Optional[np.ndarray] = None,
                               kv_cache_dtype="int8",
                               device_resize: bool = True,
                               detect_image_chunk: Optional[int] = None,
                               mesh: Optional[mesh_lib.Mesh] = None,
                               length_bucket_cascade: bool = True,
                               speculative_decode: bool = True,
                               initial_budget: Optional[int] = None,
                               weights_int8=False,
                               cascade_stats: Optional[CascadeStats] = None,
                               ) -> Iterator[List[GeneratedReport]]:
    """Yields one list of GeneratedReport per batch, in order.

    selection_override: optional [len(images), 29] bool mask decoded instead
    of the classifier's selection.
    kv_cache_dtype: the serving default "int8" (also torch.int8 or
    np.dtype("int8")), None for the parameter dtype, or a torch float dtype.
    device_resize: a batch of one uint8 shape goes up raw and is resized on
    the device (ReportGenerator.preprocess_raw); other batches are
    preprocessed on the host.
    detect_image_chunk: run the detector over sub-batches of this size
    (must divide batch_size; a final partial batch is padded to
    batch_size and the pad reports dropped).
    mesh: a core.mesh.Mesh for data-parallel serving (every rank of it
    calls this alike, with the same params: replicate them once after
    loading, core.mesh.replicate_pytree): each rank serves its shard of
    every batch and every rank yields the whole batch's reports. batch_size must be a multiple of mesh.size; a final partial
    batch is padded to batch_size and the pad reports dropped; not with
    detect_image_chunk.
    length_bucket_cascade: decode through the config's length buckets
    (RGRG.decode_selected_cascade); reports equal a full-length decode.
    speculative_decode: batches after the first decode the detector's own
    selection in the same dispatch at a predicted row budget (the largest
    of the last four batches' budgets), validated by a read of the
    selection after the next batch is queued; a miss re-decodes that batch
    from its region features at the true budget. Reports are identical
    either way. Batch 0 and a padded final batch take the synchronous
    path.
    initial_budget: a row count expected per batch, which lets batch 0
    speculate too (a low value costs only a budget-miss re-decode); with a
    mesh, each rank expects its share of it.
    weights_int8: serve the decoder's per-layer matmul weights as
    weight-only per-channel int8 (gpt2.quantize_decoder_weights): True (or
    any other true value) the "xla" layout (a plain product over the
    dequantised weights), "pallas" the layout kernel K4 reads directly;
    GPT-2 only.
    cascade_stats: an optional CascadeStats to read the cascade telemetry
    afterwards or to set the bail-out policy; one is made internally when
    the cascade is active.

    Each batch adds the regions it selected to
    `generate_reports_pipelined.rows_selected`. While spans are recorded
    (utils/logging), batch i's are tagged i on all three threads: on the
    main thread `serve.batch` (the loop's iteration) holds
    `serve.pre_wait`, `serve.detect` (the detector's dispatch, or the fused
    detect-and-decode), `serve.select_read` (the selection read, or a
    speculative batch's validation read and any re-decode), and, before
    each yield, `serve.post_wait`, then `serve.yielded` (the caller's
    time); the pre thread's `serve.preprocess` holds `pre.upload`, the
    post thread's `serve.postprocess` holds `post.copy`."""
    kv = _kv_dtype(kv_cache_dtype)
    batches = [images[i:i + batch_size] for i in range(0, len(images), batch_size)]
    if not batches:
        return
    if detect_image_chunk:
        if mesh is not None:
            raise ValueError("detect_image_chunk cannot be combined with mesh (data "
                             "parallelism already divides the batch per card)")
        if batch_size % detect_image_chunk != 0:
            raise ValueError(
                f"batch_size {batch_size} must be a multiple of detect_image_chunk "
                f"{detect_image_chunk} (a non-dividing chunk would turn chunking off)")
    # this rank's images of each batch, how many of them are real (the rest
    # pad a final partial batch) and their caller-selected regions
    real = [len(b) for b in batches]
    overrides = None if selection_override is None else [
        np.asarray(selection_override[i * batch_size:i * batch_size + n], bool)
        for i, n in enumerate(real)]
    if mesh is not None:
        if batch_size % mesh.size != 0:
            raise ValueError(f"batch_size {batch_size} must be a multiple of "
                             f"mesh.size {mesh.size}")
        rows = mesh_lib.batch_sharded(batch_size, mesh)
        batches = [(list(b) + [b[-1]] * (batch_size - len(b)))[rows] for b in batches]
        real = [min(max(n - rows.start, 0), rows.stop - rows.start) for n in real]
        if overrides is not None:
            overrides = [o[rows.start:rows.start + n] for o, n in zip(overrides, real)]
        if initial_budget is not None:
            initial_budget = -(-initial_budget // mesh.size)
    params = gen.params
    if weights_int8:
        if gen.model.cfg.decoder.kind != "gpt2":
            raise NotImplementedError(
                f"weights_int8 is not implemented for the {gen.model.cfg.decoder.kind} decoder")
        params = dict(params)
        params["decoder"] = gpt2.quantize_decoder_weights(
            params["decoder"], layout="pallas" if weights_int8 == "pallas" else "xla")
    dev = gen.device
    model = gen.model
    # with a bf16 detector the first conv casts to bf16 anyway: upload bf16
    upload_dtype = torch.bfloat16 if model.cfg.detector.dtype == "bfloat16" else None

    def preprocess(batch, batch_id: int):
        with span("serve.preprocess", batch_id):
            if detect_image_chunk and len(batch) < batch_size:
                # pad the final partial batch so the detector chunking holds
                batch = list(batch) + [batch[-1]] * (batch_size - len(batch))
            if device_resize:
                raw, arrays = gen.preprocess_raw(batch)
                if raw is not None:
                    return raw  # (uint8 [B, H, W] on the device, (wy, wx))
                batch = arrays  # mixed shapes: the already-loaded images
            return gen.preprocess(batch, transfer_dtype=upload_dtype)

    buckets_cfg = model.cfg.generation.length_buckets
    b1 = min(buckets_cfg[0], max_length) if buckets_cfg else max_length
    cascade_on = length_bucket_cascade and max_length > b1
    # turns False when rung-1 closure says the ladder is losing
    cascade_active = cascade_on
    stats = cascade_stats
    if stats is None and cascade_on:
        stats = CascadeStats()
    # the bail-out reads `bail_stats`; with a mesh each rank records into its
    # own `stats`, summed over the ranks into the caller's before each batch
    bail_stats = stats
    if mesh is not None and stats is not None:
        stats = CascadeStats(threshold=stats.threshold, min_rows=stats.min_rows)
    pad_id = model.cfg.decoder.pad_token_id

    def sync_stats() -> None:
        if mesh is not None and stats is not None:
            bail_stats.set_sum(mesh_lib.gather_objects(stats.counts(), mesh))

    recent_budgets: List[int] = []   # the last few batches' ladder budgets
    if initial_budget is not None:
        recent_budgets.append(model.budget_for(
            initial_budget, batch_size // (1 if mesh is None else mesh.size)))

    def record_budget(num_selected: int, b: int) -> None:
        recent_budgets.append(model.budget_for(num_selected, b))
        del recent_budgets[:-4]

    def continue_cascade(out, ids, decoded, rem: np.ndarray):
        """Rungs 2.. of the ladder for the rows (host mask `rem`) that
        filled bucket b1."""
        ids = F.pad(ids, (0, max_length - b1), value=pad_id)
        if rem.any():
            rem_t = torch.from_numpy(rem).to(dev)
            ids2, dec2 = model.decode_selected_cascade(
                params, out["region_features"], rem_t, max_length, kv_cache_dtype=kv,
                buckets=buckets_cfg[1:] or (max_length,), first_count=int(rem.sum()),
                num_beams=num_beams, early_stopping=early_stopping,
                stats=stats, stats_rung1=False)  # rung 1 recorded by the caller
            ids = torch.where(rem_t[:, :, None], ids2, ids)
            decoded = decoded | dec2
        return ids, decoded

    def finalize_speculative(out, budget: int, was_cascade: bool, batch_id: int):
        """Validation read of a speculatively decoded batch, made after the
        next batch is queued. was_cascade: whether its fused dispatch
        decoded at bucket b1 (the flag at dispatch time). Returns the
        post-ready outputs."""
        with span("serve.select_read", batch_id):
            sel_np = out["selected_regions"].cpu().numpy()
            num_selected = int(sel_np.sum())
            generate_reports_pipelined.rows_selected += num_selected
            record_budget(num_selected, sel_np.shape[0])
            ids, decoded = out["output_ids"], out["decoded_mask"]
            if num_selected > budget:
                # budget miss: rows past the predicted budget were not decoded;
                # decode everything again at the true budget
                ids, decoded = model.decode_selected_cascade(
                    params, out["region_features"], out["selected_regions"], max_length,
                    kv_cache_dtype=kv, first_count=num_selected, num_beams=num_beams,
                    early_stopping=early_stopping,
                    buckets=None if was_cascade else (max_length,), stats=stats)
            elif was_cascade:
                unfin = out["output_ids"][:, :, b1 - 1].cpu().numpy() != pad_id
                if num_beams > 1:
                    unfin |= ~out["decode_done"].cpu().numpy()
                rem = sel_np & out["decoded_mask"].cpu().numpy() & unfin
                if stats is not None:
                    stats.record_rung(b1, num_selected)
                    stats.record_rung1(num_selected, int(rem.sum()))
                ids, decoded = continue_cascade(out, ids, decoded, rem)
            return {"output_ids": ids, "decoded_mask": decoded,
                    "selected_regions": out["selected_regions"],
                    "class_detected": out["class_detected"],
                    "detections": {"top_region_boxes": out["top_region_boxes"]}}

    def serve_local() -> Iterator[List[GeneratedReport]]:
        """The pipeline over this process's shard of every batch; one list
        of reports per batch."""
        nonlocal cascade_active
        with cf.ThreadPoolExecutor(max_workers=1) as pre, \
                cf.ThreadPoolExecutor(max_workers=1) as post:
            pre_futures: List[Optional[cf.Future]] = []

            def ensure_pre(j: int) -> None:
                # keep the preprocess thread up to two batches ahead
                while len(pre_futures) <= min(j, len(batches) - 1):
                    k = len(pre_futures)
                    pre_futures.append(pre.submit(preprocess, batches[k], k))

            ensure_pre(0)
            post_future = None   # (the post thread's future, its batch's index)
            det_ahead = {}  # batch index -> its detect outputs, dispatched early
            # a batch awaiting its validation read:
            # (fused outputs, real images, predicted budget, was_cascade, index)
            spec_pending = None

            def submit_post(device_out, n_images, i):
                nonlocal post_future
                prev, post_future = post_future, (
                    post.submit(_postprocess, gen, device_out, n_images, i), i)
                return prev

            def submit_pending():
                """Validate the pending speculative batch and hand it to the
                post thread; returns the post future it displaced."""
                nonlocal spec_pending
                out, n_images, budget, was_cascade, i = spec_pending
                spec_pending = None
                return submit_post(finalize_speculative(out, budget, was_cascade, i),
                                   n_images, i)

            def hand_on(posted):
                """Yields the reports of a batch handed to the post thread
                (nothing for None)."""
                if posted is not None:
                    fut, i = posted
                    with span("serve.post_wait", i):
                        reports = fut.result()
                    with span("serve.yielded", i):   # the caller's time
                        yield reports

            def serve_batch(i):
                """Batch i: dispatched and handed to the post thread; yields
                the reports of the batch handed on before it."""
                nonlocal cascade_active, spec_pending
                ensure_pre(i + 2)
                sync_stats()
                if cascade_active and bail_stats is not None and bail_stats.should_bail():
                    # rung-1 closure below the break-even: later batches decode
                    # at max_length directly
                    cascade_active = False
                    bail_stats.bailed_out = stats.bailed_out = True

                with span("serve.pre_wait"):
                    pre_out = pre_futures[i].result()
                # the upload lives on in this batch's locals only (a look-ahead's
                # entry stays until here: this reads it a second time)
                pre_futures[i] = None
                device_batch, mats = pre_out if isinstance(pre_out, tuple) else (pre_out, None)
                if selection_override is None:
                    padded = int(device_batch.shape[0]) > real[i]
                    if speculative_decode and recent_budgets and not padded:
                        # speculative fused dispatch at the predicted budget,
                        # validated next iteration
                        budget = max(recent_budgets)
                        with span("serve.detect"):
                            out = model.detect_and_decode(
                                params, device_batch, None, budget,
                                b1 if cascade_active else max_length, kv_cache_dtype=kv,
                                resize_mats=mats, image_chunk=detect_image_chunk,
                                num_beams=num_beams, early_stopping=early_stopping,
                                return_features=True,  # the budget-miss re-decode's input
                                return_done=cascade_active and num_beams > 1)
                        if spec_pending is not None:
                            yield from hand_on(submit_pending())
                        spec_pending = (out, real[i], budget, cascade_active, i)
                        return

                    # synchronous split path: batch 0 (seeds the predictor), a
                    # padded final batch (its pad rows' selection is zeroed on
                    # the host), or speculative_decode=False
                    with span("serve.detect"):
                        det = (det_ahead.pop(i) if i in det_ahead
                               else model.detect(params, device_batch, mats,
                                                 image_chunk=detect_image_chunk))
                    # lookahead (no speculation): queue detect(i+1) before the
                    # selection read below, if its preprocessing is done
                    if (not speculative_decode and i + 1 < len(batches)
                            and pre_futures[i + 1].done()):
                        nxt = pre_futures[i + 1].result()
                        nxt_imgs, nxt_mats = nxt if isinstance(nxt, tuple) else (nxt, None)
                        with span("serve.detect", i + 1):
                            det_ahead[i + 1] = model.detect(params, nxt_imgs, nxt_mats,
                                                            image_chunk=detect_image_chunk)
                    if spec_pending is not None:
                        # the previous batch was speculative: validate it now
                        yield from hand_on(submit_pending())
                    sel = det["selected_regions"]
                    with span("serve.select_read"):
                        sel_np = sel.cpu().numpy()  # the host picks the row budget
                    if sel_np.shape[0] > real[i]:
                        # padded final batch: its pad images select nothing
                        sel_np = sel_np.copy()
                        sel_np[real[i]:] = False
                        sel = torch.from_numpy(sel_np).to(dev)
                    num_selected = int(sel_np.sum())
                    generate_reports_pipelined.rows_selected += num_selected
                    record_budget(num_selected, sel_np.shape[0])
                    if length_bucket_cascade and (cascade_active or not cascade_on):
                        ids, decoded = model.decode_selected_cascade(
                            params, det["region_features"], sel, max_length,
                            kv_cache_dtype=kv, first_count=num_selected, num_beams=num_beams,
                            early_stopping=early_stopping, stats=stats)
                    else:
                        ids, decoded = model.decode_selected(
                            params, det["region_features"], sel,
                            model.budget_for(num_selected, int(device_batch.shape[0])),
                            max_length, kv_cache_dtype=kv, num_beams=num_beams,
                            early_stopping=early_stopping)
                    device_out = {"output_ids": ids, "decoded_mask": decoded,
                                  "selected_regions": sel,
                                  "class_detected": det["class_detected"],
                                  "detections": {"top_region_boxes": det["top_region_boxes"]}}
                else:
                    # caller-selected regions: detect and decode in one dispatch
                    host_sel = overrides[i]
                    pad_b = int(device_batch.shape[0]) - real[i]
                    if pad_b:  # padded final batch: pad rows select nothing
                        host_sel = np.concatenate(
                            [host_sel, np.zeros((pad_b, host_sel.shape[1]), bool)])
                    sel = torch.from_numpy(np.ascontiguousarray(host_sel, bool)).to(dev)
                    n_sel = int(host_sel.sum())
                    generate_reports_pipelined.rows_selected += n_sel
                    r_budget = model.budget_for(n_sel, int(device_batch.shape[0]))
                    with span("serve.detect"):
                        out = model.detect_and_decode(
                            params, device_batch, sel, r_budget,
                            b1 if cascade_active else max_length, kv_cache_dtype=kv,
                            resize_mats=mats, image_chunk=detect_image_chunk,
                            num_beams=num_beams, early_stopping=early_stopping,
                            return_features=cascade_active,
                            return_done=cascade_active and num_beams > 1)
                    ids, decoded = out["output_ids"], out["decoded_mask"]
                    if cascade_active:
                        # one small read decides whether rows go on to rung 2:
                        # greedy, a real token in the last slot; beam, that or
                        # an open search
                        unfin = ids[:, :, b1 - 1].cpu().numpy() != pad_id
                        if num_beams > 1:
                            unfin |= ~out["decode_done"].cpu().numpy()
                        rem = host_sel & decoded.cpu().numpy() & unfin
                        if stats is not None:
                            stats.record_rung(b1, n_sel)
                            stats.record_rung1(n_sel, int(rem.sum()))
                        ids, decoded = continue_cascade(out, ids, decoded, rem)
                    device_out = {"output_ids": ids, "decoded_mask": decoded,
                                  "selected_regions": sel,
                                  "class_detected": out["class_detected"],
                                  "detections": {"top_region_boxes": out["top_region_boxes"]}}

                # the post thread copies the batch to the host and assembles it
                yield from hand_on(submit_post(device_out, real[i], i))

            for i in range(len(batches)):
                with span("serve.batch", i):
                    yield from serve_batch(i)
            if spec_pending is not None:
                # the last batch was speculative: validate it now
                yield from hand_on(submit_pending())
            yield from hand_on(post_future)

    if mesh is None:
        yield from serve_local()
        return
    for reports in serve_local():
        yield [r for part in mesh_lib.gather_objects(reports, mesh) for r in part]
    sync_stats()


generate_reports_pipelined.rows_selected = 0
