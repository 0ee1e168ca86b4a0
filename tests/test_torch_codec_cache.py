"""The port's codec singleton (`tokenizers.get_audio_tokenizer`) keeps one
codec of a count: a codec installed from a path is the one every later
call gets, whatever string names the device, and a call on another device
loads the same path there. A random-init codec is made only when no path
is known for the count. On the CPU, with the loader replaced by one that
records its calls (no real checkpoint is in the repository); the card's
"cuda" against "cuda:0" is a test in `tests/test_torch_cuda.py`."""

import pytest
import torch

from csm_mlx_tpu_torch import tokenizers as ttok
from csm_mlx_tpu_torch.models.mimi import mimi as mimi_module
from csm_mlx_tpu_torch.models.mimi import weights


@pytest.fixture
def loader(monkeypatch, tmp_path):
    """(a checkpoint path that exists, the loader's calls): the loader
    returns a stand-in parameter tree naming its path and device."""
    path = tmp_path / "mimi.safetensors"
    path.write_bytes(b"")
    calls = []

    def fake_load(p, cfg, dtype=torch.float32, device=None):
        calls.append((p, str(device)))
        return {"source": p, "device": str(device)}

    monkeypatch.delenv(ttok.MIMI_WEIGHTS_ENV, raising=False)
    monkeypatch.setattr(weights, "load_mimi_checkpoint", fake_load)
    ttok.get_audio_tokenizer.cache_clear()
    yield str(path), calls
    ttok.get_audio_tokenizer.cache_clear()


def _no_random_init(monkeypatch):
    def fail(*a, **k):
        raise AssertionError("a random-init codec beside an installed one")

    monkeypatch.setattr(mimi_module, "init_mimi_params", fail)


@pytest.mark.parametrize("install,call", [("cpu", "cpu:0"), ("cpu:0", "cpu"),
                                          ("cpu", None)])
def test_install_is_the_instance_every_device_string_gets(loader,
                                                          monkeypatch,
                                                          install, call):
    path, calls = loader
    codec = ttok.get_audio_tokenizer(8, path, device=install)
    _no_random_init(monkeypatch)
    if call is None:  # no device: the card, absent here, is not taken
        with pytest.raises(RuntimeError, match="CUDA"):
            ttok.get_audio_tokenizer(8)
        return
    assert ttok.get_audio_tokenizer(8, device=call) is codec
    assert ttok.get_audio_tokenizer(8, path, device=call) is codec
    assert codec.params["source"] == path and calls == [(path, "cpu")]


def test_another_device_loads_the_installed_path(loader, monkeypatch):
    """An install on the CPU, then a call on another device without a
    path: the same checkpoint is loaded there, never a random init."""
    path, calls = loader
    cpu = ttok.get_audio_tokenizer(8, path, device="cpu")
    _no_random_init(monkeypatch)
    other = ttok.get_audio_tokenizer(8, device="meta")
    assert other is not cpu and other.params["source"] == path
    assert calls == [(path, "cpu"), (path, "meta")]
    assert ttok.get_audio_tokenizer(8, device="cpu") is cpu


def test_an_install_replaces_random_init_codecs_of_the_count(loader):
    """A random-init codec made before any path was known is dropped by an
    install on another device: the next call on its device loads the
    path."""
    path, calls = loader
    random_cpu = ttok.get_audio_tokenizer(8, device="cpu")
    assert "decoder" in random_cpu.params  # a random init
    ttok.get_audio_tokenizer(8, path, device="meta")
    again = ttok.get_audio_tokenizer(8, device="cpu")
    assert again is not random_cpu and again.params["source"] == path
    assert calls == [(path, "meta"), (path, "cpu")]
