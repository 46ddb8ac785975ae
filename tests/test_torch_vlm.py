"""The port's VLM baseline (agenda_tpu_torch.cli.vlm_baseline) against agenda_tpu's.

The parsers and the offline ``responses`` backend give the same boxes and
the same COCO JSON as the JAX package's for the gemini, internvl and
deepseek conventions (seeded responses with swapped corners, malformed
lines, 3-number boxes and empty answers); the gemini and transformers
backends raise, naming what the port's installations lack.
"""

import json

import numpy as np
import pytest

from agenda_tpu.cli import vlm_baseline as jvlm
from agenda_tpu_torch.cli import vlm_baseline as vlm


def seeded_response(rng: np.random.Generator) -> str:
    lines = ["Here are the bounding boxes:"]
    for _ in range(int(rng.integers(0, 6))):
        box = rng.integers(0, 1000, 4)
        lines.append(f"[{box[0]}, {box[1]}, {box[2]}, {box[3]}]")
    lines += ["[12, 34, 56]", "car at [ 5 , 6 , 7 , 8 ] maybe", "no box here", "[a, b, c, d]"]
    rng.shuffle(lines)
    return "\n".join(lines)


def test_parsers_equal_jax():
    rng = np.random.default_rng(0)
    assert vlm.MODEL_FORMATS == jvlm.MODEL_FORMATS
    for _ in range(20):
        text = seeded_response(rng)
        boxes = vlm.parse_list_boxes(text)
        assert boxes == jvlm.parse_list_boxes(text)
        for order, denom in vlm.MODEL_FORMATS.values():
            args = (boxes, int(rng.integers(0, 9)), int(rng.integers(0, 50)), 112, 96)
            assert (vlm.boxes_to_annotations(*args, order=order, denom=denom)
                    == jvlm.boxes_to_annotations(*args, order=order, denom=denom))


@pytest.mark.parametrize("model_format", ["gemini", "internvl", "deepseek"])
def test_responses_backend_writes_the_jax_json(tmp_path, model_format):
    rng = np.random.default_rng(1)
    gt = {"categories": [{"id": 1, "name": "small"}],
          "images": [{"id": i, "file_name": f"{i}.png", "width": 112, "height": 112}
                     for i in range(6)],
          "annotations": []}
    (tmp_path / "gt.json").write_text(json.dumps(gt))
    responses = {f"{i}.png": seeded_response(rng) for i in range(5)}  # 5.png: no answer
    (tmp_path / "resp.json").write_text(json.dumps(responses))
    common = ["--backend", "responses", "--responses_file", str(tmp_path / "resp.json"),
              "--test_data_base_path", str(tmp_path), "--annotation_file", "gt.json",
              "--model_format", model_format]
    got = vlm.main(common + ["--save_path", str(tmp_path / "port.json")])
    want = jvlm.main(common + ["--save_path", str(tmp_path / "jax.json")])
    assert got == want and got["annotations"]
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    assert vlm.parse_args(common).prompt == jvlm.parse_args(common).prompt


@pytest.mark.parametrize("backend,names", [("gemini", "Gemini API"),
                                           ("transformers", "transformers")])
def test_online_backends_raise(tmp_path, backend, names):
    (tmp_path / "gt.json").write_text(json.dumps({"categories": [], "images": [],
                                                  "annotations": []}))
    with pytest.raises(SystemExit, match=names):
        vlm.main(["--backend", backend, "--test_data_base_path", str(tmp_path),
                  "--annotation_file", "gt.json", "--save_path", str(tmp_path / "o.json")])
