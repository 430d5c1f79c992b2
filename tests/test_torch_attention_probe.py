"""``scripts/torch_attention_probe.py`` times the flash-attention kernel on
the inputs a DistilBERT forward gives it, read by forward pre-hooks on the
attention modules. Here, on the CPU and the small preset, those inputs are
held bitwise against what the wrapper ``flash_attention_fwd`` is actually
called with in the same forward.
"""

import importlib.util
import os

import torch

from network_distributed_pytorch_tpu_torch.data.imdb import prepare_imdb
from network_distributed_pytorch_tpu_torch.experiments import powersgd_imdb
from network_distributed_pytorch_tpu_torch.ops import flash_attention as fa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _probe():
    spec = importlib.util.spec_from_file_location(
        "torch_attention_probe", os.path.join(REPO, "scripts", "torch_attention_probe.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Small:
    """``powersgd_imdb`` with its small preset in place of the full one."""

    @staticmethod
    def build(cfg, preset, device, group=None):
        return powersgd_imdb.build(cfg, "small", device, group)

    sequence_classifier_loss = staticmethod(powersgd_imdb.sequence_classifier_loss)


def test_probe_captures_the_wrappers_inputs(monkeypatch):
    cfg = powersgd_imdb.default_config()
    cfg.global_batch_size = 4
    imdb, _, _ = prepare_imdb(max_len=64, vocab_size=1024, seed=cfg.seed)
    arrays = [imdb["input_ids"], imdb["attention_mask"], imdb["labels"]]
    called, wrapper = [], fa.flash_attention_fwd

    def spy(*args):
        called.append(args)
        return wrapper(*args)

    monkeypatch.setattr(fa, "flash_attention_fwd", spy)
    captured = _probe().path_inputs(_Small, cfg, arrays, torch.device("cpu"))
    assert len(captured) == len(called) == 2  # the small preset's layers
    for got, want in zip(captured, called):
        assert len(got) == len(want) == 8
        for a, b in zip(got, want):
            assert torch.equal(a, b) if torch.is_tensor(b) else a == b
