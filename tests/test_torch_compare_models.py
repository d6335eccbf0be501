"""``hpmn_tpu_torch/tools/compare_models.py`` on the CPU at a tiny size:
two families (SVD++ and BST) through the CLI with ``--device cpu``, the
table and the JSON of the JAX tool; each family's config is the dataset's
hpmn config with the name replaced, as in JAX; ``--device`` defaults to
the card."""

import dataclasses
import json

import numpy as np

from hpmn_tpu_torch import configs
from hpmn_tpu_torch.tools import compare_models


def test_two_families_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "table.json"
    compare_models.main(["--dataset", "amazon", "--models", "svdpp,bst",
                         "--steps", "8", "--n_examples", "400",
                         "--batch_size", "16", "--device", "cpu",
                         "--json", str(out)])
    text = capsys.readouterr().out
    assert "== final table (sorted by test AUC) ==" in text
    assert "svdpp: test AUC" in text and "bst: test AUC" in text
    got = json.loads(out.read_text())
    assert (got["dataset"], got["steps"], got["seed"]) == ("amazon", 8, 0)
    assert set(got["results"]) == {"svdpp", "bst"}
    for res in got["results"].values():
        assert 0.0 <= res["auc"] <= 1.0 and np.isfinite(res["log_loss"])


def test_family_config_and_defaults():
    cfg = compare_models.family_config("caser", dataset="xlong", steps=10,
                                       batch_size=8, use_pallas=True)
    base = configs.get_config("xlong_hpmn")
    assert cfg.model == dataclasses.replace(base.model, name="caser",
                                            use_pallas=True)
    assert (cfg.train.max_steps, cfg.train.eval_every, cfg.train.batch_size,
            cfg.train.steps_per_dispatch) == (10, 2, 8, 1)
    assert compare_models.DEFAULT_MODELS.split(",") == list(
        __import__("hpmn_tpu_torch.models.model",
                   fromlist=["ENCODERS"]).ENCODERS)
    assert compare_models.compare.__defaults__[0] == "cuda"
