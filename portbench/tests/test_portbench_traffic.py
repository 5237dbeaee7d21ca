"""The general generator: the same seed gives the same batches, every seed
the same work in each batch, batches of each stratum's rows in turn, and
no draw overflows the capacities."""
import numpy as np
import pytest
import torch

from portbench import scenes


@pytest.mark.parametrize("name", ["gen_batch", "train_published"])
def test_deterministic_per_seed(name):
    mix = scenes.load(name)
    seed = 2 ** 31 + 12345
    a = scenes.graph_batch(mix, 9, 16, seed, 3)
    b = scenes.graph_batch(mix, 9, 16, seed, 3)
    c = scenes.graph_batch(mix, 9, 16, seed + 1, 3)
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, b[k]), k
    assert not torch.equal(a["objs"], c["objs"])


@pytest.mark.parametrize("name", ["gen_batch", "train_published"])
def test_same_work_every_seed_and_no_overflow(name):
    mix = scenes.load(name)
    n_cap, t_cap = scenes.capacities(mix)
    totals = scenes.batch_totals(mix)
    assert len(set(totals)) == mix["strata"]
    # the strata's medians lie around the uniform's mean, in turn
    mean = mix["scenes"] * (mix["objects_min"] + mix["objects_max"]) / 2
    assert abs(sum(totals) / len(totals) - mean) < 1
    counts = []
    for index in range(4):
        rows = set()
        for seed in (0, 1, 2 ** 31 + 7, 2 ** 32 + 3):
            g = scenes.graph_batch(mix, 9, 16, seed, index)
            real = int(g["obj_mask"].sum())
            rows.add(real)
            assert real <= n_cap and int(g["triple_mask"].sum()) <= t_cap
            assert g["real_nodes"] == real
            # real nodes are a prefix and every real triple stays in it
            assert g["obj_mask"][:real].all() and not g["obj_mask"][real:].any()
            tri = g["triples"][g["triple_mask"] > 0]
            assert int(tri[:, [0, 2]].max()) < real
            sizes = np.bincount(g["obj_to_scene"][:real].numpy())
            counts.append(sizes - 1)
        # batch `index` has the same rows under every seed
        assert rows == {totals[index % len(totals)] + mix["scenes"]}
    counts = np.concatenate(counts)
    assert counts.min() >= mix["objects_min"]
    assert counts.max() <= mix["objects_max"]
    # the counts are drawn: both ends of the range are met
    assert counts.min() == mix["objects_min"]
    assert counts.max() == mix["objects_max"]
    # the most objects any scene can draw still fit
    assert mix["scenes"] * (mix["objects_max"] + 1) <= n_cap


def test_gen_batch_rows():
    mix = scenes.load("gen_batch")
    rows = [scenes.graph_batch(mix, 9, 16, 5, i)["real_nodes"]
            for i in range(4)]
    assert rows == [272, 288, 256, 272]
    assert all(r % mix["row_multiple"] == 0 for r in rows)


def test_analytic_sdfs():
    a = scenes.analytic_sdfs(6, 4, 16, 0.2, 11, 0, "cpu")
    b = scenes.analytic_sdfs(6, 4, 16, 0.2, 11, 0, "cpu")
    assert torch.equal(a, b)
    assert a.shape == (6, 16, 16, 16, 1)
    assert float(a.abs().max()) <= float(torch.tensor(0.2))
    assert not a[4:].any() and all(a[i].min() < 0 < a[i].max()
                                   for i in range(4))


def test_greedy_rows():
    mix = scenes.load("train_published")
    g = scenes.graph_batch(mix, 9, 16, 3, 0)
    rows = scenes.greedy_rows(g, mix["shape_rows"])
    sizes = np.bincount(g["obj_to_scene"].numpy()[g["obj_mask"].numpy() > 0])
    assert rows == int(np.cumsum(sizes)[np.cumsum(sizes) <= 64][-1])
