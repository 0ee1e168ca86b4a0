"""Datasets for fine-tuning (port of `csm_mlx_tpu/finetune/dataset.py`):
the same JSON schemas, constructors and `get_batch` outputs.

- `_tokenize` turns an item's segments into rows and a loss mask
  (`tokenizers.tokenize_segments_with_loss_mask`: text rows, Mimi's codes
  of each turn's audio, read from its `audio_path`), through `mimi`, by
  default the codec singleton on the card;
- per-item tokenization results are cached after first touch;
- `get_batch` pads to a bucketed length (multiples of `pad_multiple`, 64
  by default), as the JAX package does for its jitted step.

JSON schemas:
  CSMDataset:          [[{"text","audio_path","speaker"}, ...], ...]
  CSMPairwiseDataset:  [{"chosen": [...], "rejected": [...]}, ...]
  CSMPointwiseDataset: [{"segments": [...], "preference": ±1}, ...]
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from csm_mlx_tpu_torch.segment import Segment


def _bucket_len(n: int, multiple: int) -> int:
    return max(((n + multiple - 1) // multiple) * multiple, multiple)


def _pad_stack(arrays: List[np.ndarray], max_len: int) -> np.ndarray:
    out = np.zeros((len(arrays), max_len, arrays[0].shape[1]),
                   dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0]] = a
    return out


def _segments_from_json(items) -> List[Segment]:
    return [
        Segment(
            text=item["text"],
            audio_path=Path(item["audio_path"]),
            speaker=item.get("speaker", 0),
        )
        for item in items
    ]


class CSMDataset:
    """Dataset of conversations (list of Segment lists)."""

    def __init__(
        self,
        samples: List[List[Segment]],
        n_audio_codebooks: int = 32,
        max_audio_length_ms: Optional[int] = None,
        mask_speaker_ids: Optional[int | List[int]] = None,
        pad_multiple: int = 64,
        cache_tokenization: bool = True,
        mimi=None,
    ):
        self.samples = samples
        self.mimi = mimi
        self.n_audio_codebooks = n_audio_codebooks
        self.max_audio_length_ms = max_audio_length_ms
        self.mask_speaker_ids = (
            mask_speaker_ids
            if isinstance(mask_speaker_ids, list)
            else [mask_speaker_ids] if mask_speaker_ids is not None else []
        )
        self.pad_multiple = pad_multiple
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        self._cache_enabled = cache_tokenization

    # Subclasses override only the per-item parser; the JSON-load plumbing
    # and constructor-kwarg threading live here once.
    @staticmethod
    def _parse_item(item):
        return _segments_from_json(item)

    @classmethod
    def from_json(
        cls,
        json_path: str,
        n_audio_codebooks: int = 32,
        max_audio_length_ms: Optional[int] = None,
        mask_speaker_ids: Optional[int | List[int]] = None,
        **kwargs,
    ):
        with open(json_path, "r") as f:
            data = json.load(f)
        return cls([cls._parse_item(item) for item in data],
                   n_audio_codebooks=n_audio_codebooks,
                   max_audio_length_ms=max_audio_length_ms,
                   mask_speaker_ids=mask_speaker_ids, **kwargs)

    def __len__(self) -> int:
        return len(self.samples)

    def _tokenize(self, segments: List[Segment]):
        from csm_mlx_tpu_torch.tokenizers import \
            tokenize_segments_with_loss_mask

        return tokenize_segments_with_loss_mask(
            segments,
            n_audio_codebooks=self.n_audio_codebooks,
            mask_speaker_ids=self.mask_speaker_ids,
            max_audio_length_ms=self.max_audio_length_ms,
            mimi=self.mimi,
        )

    def __getitem__(self, idx: int):
        if self._cache_enabled and idx in self._cache:
            return self._cache[idx]
        item = self._tokenize(self.samples[idx])
        if self._cache_enabled:
            self._cache[idx] = item
        return item

    def get_batch(self, indices: List[int]) -> Dict[str, np.ndarray]:
        toks, msks, lmsks = [], [], []
        for idx in indices:
            t, m, lm = self[idx]
            toks.append(t)
            msks.append(m)
            lmsks.append(lm)
        max_len = _bucket_len(max(t.shape[0] for t in toks), self.pad_multiple)
        return {
            "tokens": _pad_stack(toks, max_len),
            "masks": _pad_stack(msks, max_len),
            "loss_masks": _pad_stack(lmsks, max_len),
        }


class CSMPairwiseDataset(CSMDataset):
    """Chosen/rejected conversation pairs (DPO)."""

    def __init__(self, pairs: List[Tuple[List[Segment], List[Segment]]], **kwargs):
        super().__init__([], **kwargs)
        self.pairs = pairs

    @staticmethod
    def _parse_item(item):
        return (_segments_from_json(item["chosen"]),
                _segments_from_json(item["rejected"]))

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, idx: int):
        if self._cache_enabled and idx in self._cache:
            return self._cache[idx]
        chosen, rejected = self.pairs[idx]
        item = {"chosen": self._tokenize(chosen),
                "rejected": self._tokenize(rejected)}
        if self._cache_enabled:
            self._cache[idx] = item
        return item

    def get_batch(self, indices: List[int]) -> Dict[str, np.ndarray]:
        parts = {f"{k}_{f}": [] for k in ("chosen", "rejected")
                 for f in ("tokens", "masks", "loss_masks")}
        for i in indices:
            ex = self[i]
            for key in ("chosen", "rejected"):
                t, m, lm = ex[key]
                parts[f"{key}_tokens"].append(t)
                parts[f"{key}_masks"].append(m)
                parts[f"{key}_loss_masks"].append(lm)
        all_lens = [t.shape[0] for k in ("chosen", "rejected")
                    for t in parts[f"{k}_tokens"]]
        max_len = _bucket_len(max(all_lens), self.pad_multiple)
        return {k: _pad_stack(v, max_len) for k, v in parts.items()}


class CSMPointwiseDataset(CSMDataset):
    """Conversations with a ±1 preference (KTO)."""

    def __init__(self, entries: List[Tuple[List[Segment], int]], **kwargs):
        super().__init__([], **kwargs)
        self.entries = entries

    @staticmethod
    def _parse_item(item):
        return (_segments_from_json(item["segments"]),
                int(item["preference"]))

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, idx: int):
        if self._cache_enabled and idx in self._cache:
            return self._cache[idx]
        segments, label = self.entries[idx]
        item = (*self._tokenize(segments), label)
        if self._cache_enabled:
            self._cache[idx] = item
        return item

    def get_batch(self, indices: List[int]) -> Dict[str, np.ndarray]:
        toks, msks, lmsks, prefs = [], [], [], []
        for i in indices:
            t, m, lm, p = self[i]
            toks.append(t)
            msks.append(m)
            lmsks.append(lm)
            prefs.append(p)
        max_len = _bucket_len(max(t.shape[0] for t in toks), self.pad_multiple)
        return {
            "tokens": _pad_stack(toks, max_len),
            "masks": _pad_stack(msks, max_len),
            "loss_masks": _pad_stack(lmsks, max_len),
            "preferences": np.asarray(prefs, dtype=np.int32),
        }
