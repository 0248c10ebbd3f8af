"""The model's parts: the detector (detector.py over resnet.py, heads.py,
layers.py), the sentence decoders (gpt2.py, moonlight.py) and the whole
pipeline (full_model.py)."""


def decoder_module(cfg):
    """The module of models/ that runs the decoder `cfg` (a DecoderConfig)
    names by its `kind`: prefill, decode_step, decode_step_beam and the
    beam step's pieces (decode/beam.StepGraphs)."""
    if cfg.kind == "moonlight":
        from rgrg_tpu_torch.models import moonlight
        return moonlight
    from rgrg_tpu_torch.models import gpt2
    return gpt2
