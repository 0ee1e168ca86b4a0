"""A tiny configuration of the cells' model and the helpers that run a
driver on the CPU with it (tests only)."""

from __future__ import annotations

import copy
import json
import os

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_config() -> dict:
    with open(os.path.join(HERE, "configs", "csm-1b-w8a8.json")) as fh:
        cfg = json.load(fh)
    cfg = copy.deepcopy(cfg)
    cfg["name"] = "tiny-w8a8"
    cfg["text_vocab_size"] = 128
    cfg["audio_vocab_size"] = 67
    cfg["audio_num_codebooks"] = 8
    cfg["backbone"].update(num_hidden_layers=2, num_attention_heads=4,
                           num_key_value_heads=2, head_dim=16,
                           intermediate_size=128, hidden_size=64)
    cfg["decoder"].update(num_hidden_layers=2, num_attention_heads=2,
                          num_key_value_heads=1, head_dim=16,
                          intermediate_size=64, hidden_size=32)
    cfg["mimi"].update(num_quantizers=8, codebook_size=64, codebook_dim=16,
                       hidden_size=32, num_filters=4, num_hidden_layers=1,
                       intermediate_size=64, num_attention_heads=2,
                       num_key_value_heads=2, head_dim=16,
                       upsample_groups=32)
    return cfg


class Ctx:
    """A driver's context on the CPU, without the harness's look for a
    chip."""

    def __init__(self, cell: dict, mix: dict, config: dict, seed: int,
                 seconds: float, control: bool = False):
        self.cell, self.mix, self.config = cell, mix, config
        self.name = "tiny"
        self.seed, self.seconds, self.trace = seed, seconds, False
        self.device = torch.device("cpu")
        self.control = control
        self.logs = []
        self.t_start = 0.0

    def log(self, msg):
        self.logs.append(msg)

    def sync(self):
        pass

    def setup_done(self):
        return 0.0

    def memory_peak(self):
        return 0

    def free(self):
        pass

    @staticmethod
    def quantile(values, q):
        import numpy as np

        return float(np.percentile(values, 100 * q)) if len(values) else None
