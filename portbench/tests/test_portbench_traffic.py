"""The traffic generator: everything it hands the program follows from
the seed, every seed offers the same sizes, and a served request decodes
exactly the tokens its mix's ratio gives."""

import importlib

import numpy as np
import pytest
import torch

from portbench import spec, system, traffic
from portbench.tests import tiny
from portbench.trace import Tracer

MIXES = sorted(p.stem for p in (spec.HERE / "traffic").glob("*.json"))


@pytest.mark.parametrize("mix", MIXES)
def test_sizes_repeat_from_the_seed_and_cover_the_table_each_cycle(mix):
    t = spec.load_json(spec.HERE / "traffic" / f"{mix}.json")
    dist = t.get("text_ids") or t.get("tokens") or t["clip_s"]
    n = t.get("table") or t["clips"]
    seed = 2 ** 31 + 12345
    a, b = traffic.Sizes(dist, n, seed), traffic.Sizes(dist, n, seed)
    other = traffic.Sizes(dist, n, seed + 1)
    first = [a[j] for j in range(5 * n)]
    assert first == [b[j] for j in range(5 * n)]
    assert first != [other[j] for j in range(5 * n)]
    table = sorted(traffic.quantile_table(dist, n))
    for c in range(5):
        assert sorted(first[c * n:(c + 1) * n]) == table
    assert sorted(other[j] for j in range(n)) == table
    assert dist["min"] <= table[0] and table[-1] <= dist["max"]


def test_quantile_tables():
    lu = traffic.quantile_table({"dist": "loguniform", "min": 400, "max": 1200}, 8)
    assert 400 < lu[0] < lu[-1] < 1200
    assert np.allclose(np.diff(np.log(lu)), np.log(3) / 8)
    with pytest.raises(ValueError):
        traffic.quantile_table({"dist": "zipf"}, 4)


def test_request_inputs_repeat_from_the_seed():
    s = 3 * 2 ** 31 + 7
    assert traffic.request_seed(s, 4) == traffic.request_seed(s, 4)
    assert traffic.request_seed(s, 4) != traffic.request_seed(s, 5)
    assert 0 <= traffic.request_seed(s, 4) < 2 ** 31
    ids = traffic.text_ids(s, 4, 30, 60515)
    assert ids.shape == (1, 30) and ids.dtype == np.int64
    assert np.array_equal(ids, traffic.text_ids(s, 4, 30, 60515))
    assert not np.array_equal(ids, traffic.text_ids(s + 1, 4, 30, 60515))
    assert ids.min() >= 0 and ids.max() < 60515


@pytest.mark.parametrize("mix", ["stream16", "stream8"])
def test_served_requests_decode_the_tokens_their_ratio_gives(mix):
    config = tiny.config_300m() if mix == "stream16" else tiny.config_cv2()
    cell = tiny.cell(config, mix, **tiny.ENGINE)
    ratio = cell.traffic["token_text_ratio"]
    drivers = importlib.import_module("portbench.drivers.engine")
    inference = drivers.Driver.inference(cell)
    assert inference == {"min_token_text_ratio": ratio, "max_token_text_ratio": ratio}
    seed = 2 ** 31 + 9
    drv = drivers.Driver(cell, system.build(config, seed, torch.device("cpu"), inference),
                         seed, system.plain_config(config))
    drv.warm()
    drv.measure(2.0, Tracer(False))
    done = [r for r in drv.requests if r.tokens is not None and r.err is None]
    assert done and all(r.cap == int(r.n_ids * ratio) for r in drv.requests)
    for r in done:
        if config["family"] == "cosyvoice":
            assert len(r.tokens) == r.cap
        else:  # an attempt that samples a fill id emits nothing
            assert 0 < len(r.tokens) <= r.cap
    assert sorted(r.n_ids for r in drv.requests[:cell.traffic["clients"]]) == \
        sorted(int(round(drv.sizes[j])) for j in range(cell.traffic["clients"]))
