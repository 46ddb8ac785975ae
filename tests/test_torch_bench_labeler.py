"""The port's stack labeler (``agenda_tpu_torch/detect/bench_labeler.py``)
on the CPU, at one epoch: it trains, calibrates and caches with the JAX
package's keys and layout, takes its cache without training, and trains
again when the epochs, the domain fingerprint or ``retrain`` ask it to.
"""

import json
import os

import numpy as np
import pytest
import torch

from agenda_tpu.detect import bench_labeler as jlab
from agenda_tpu.detect.runner import load_variables as jax_load_variables
from agenda_tpu_torch.cli import select_threshold
from agenda_tpu_torch.detect import bench_labeler as lab
from agenda_tpu_torch.detect.dataset import CocoDetDataset
from agenda_tpu_torch.detect.runner import DetectorRunner, RunnerConfig
from agenda_tpu_torch.io.procedural import make_heatmap_domain

EPOCHS = 1


class Retrained(Exception):
    pass


def _no_training(monkeypatch):
    def train(self, *a, **k):
        raise Retrained

    monkeypatch.setattr(DetectorRunner, "train", train)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module: under the suite's parallel workers
    more threads only contend, and the calibration's scores and the
    re-prediction's are then summed in one order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trained(tmp_path_factory, _one_torch_thread):
    cache = str(tmp_path_factory.mktemp("labeler"))
    logs = []
    fam, variables, thr = lab.prepare_stack_labeler(cache, epochs=EPOCHS, device="cpu",
                                                    log=logs.append)
    return cache, fam, variables, thr, logs


def test_trains_calibrates_and_writes_the_jax_meta_and_layout(trained):
    cache, fam, variables, thr, logs = trained
    assert (lab.META, lab.CKPT, lab.MODEL_KW) == (jlab._META, jlab._CKPT, jlab.MODEL_KW)
    with open(os.path.join(cache, lab.META)) as f:
        meta = json.load(f)
    assert set(meta) == {"threshold", "ap", "f1_max", "model_kw", "epochs", "domain_sha"}
    assert meta["threshold"] == thr and meta["epochs"] == EPOCHS
    assert meta["model_kw"] == lab.MODEL_KW and meta["domain_sha"] == lab.domain_fingerprint()
    assert meta["domain_sha"] != jlab._domain_fingerprint()  # a JAX cache is not the port's
    assert 0.0 <= meta["ap"] <= 1.0 and 0.0 <= meta["f1_max"] <= 1.0
    assert "quick-training" in logs[0] and "trained" in logs[-1]
    # the JAX runner reads the checkpoint: the port's variables in flax names
    jvars = jax_load_variables(os.path.join(cache, lab.CKPT))
    flat = {}
    for col, tree in jvars.items():
        stack = [((col,), tree)]
        while stack:
            key, node = stack.pop()
            if isinstance(node, dict):
                stack += [(key + (k,), v) for k, v in node.items()]
            else:
                flat[".".join(key)] = np.asarray(node)
    want = fam.to_flax(variables)
    assert set(flat) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], np.asarray(v), err_msg=k)


def test_a_second_call_takes_the_cache_without_training(trained, monkeypatch, tmp_path):
    """Training raises, so the call must come from the cache; its weights and
    threshold are the trained ones, and the threshold is select_threshold's
    on the port's own runner.test records of those weights."""
    cache, _, variables, thr, _ = trained
    _no_training(monkeypatch)
    logs = []
    fam, cached, cthr = lab.prepare_stack_labeler(cache, epochs=EPOCHS, device="cpu",
                                                  log=logs.append)
    assert cthr == thr and "cached" in logs[0]
    assert set(cached) == set(variables)
    for k, v in variables.items():
        assert torch.equal(cached[k], v), k
    val = str(tmp_path / "val")
    make_heatmap_domain(val, lab.VAL_TILES, seed=lab.VAL_SEED, **lab.DOMAIN_KW)
    ds = CocoDetDataset(val, "ann.json", "daam_stack_heatmaps/", img_scale=(128, 128),
                        max_gt=8, train=False)
    runner = DetectorRunner(fam, RunnerConfig(batch_size=2), device="cpu")
    pkl = str(tmp_path / "pred.pkl")
    runner.test(cached, ds, out_pkl=pkl)
    assert select_threshold.main(["--prediction_pkl", pkl])["threshold"] == thr


@pytest.mark.parametrize("change", ["epochs", "domain_sha", "retrain"])
def test_a_changed_key_or_retrain_trains_again(trained, monkeypatch, change):
    cache = trained[0]
    _no_training(monkeypatch)
    kw = dict(epochs=EPOCHS, device="cpu", log=lambda s: None)
    if change == "epochs":
        kw["epochs"] = EPOCHS + 1
    elif change == "domain_sha":
        monkeypatch.setattr(lab, "domain_fingerprint", lambda: "0" * 16)
    else:
        kw["retrain"] = True
    with pytest.raises(Retrained):
        lab.prepare_stack_labeler(cache, **kw)
