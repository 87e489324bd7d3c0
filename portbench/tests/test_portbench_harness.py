"""The harness on the CPU: BENCHMARK.json's names, the files found by
name, the work counts, the trace arithmetic, the reference against the
program at a small size, and the no-JAX check."""
import json
import math
import os
import re

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import common, counts, readers
from portbench.reference import draws as dr
from portbench.reference import train as ref
from portbench.reference.model import Arch, Forward, make_weights
from portbench.tests.variants import B3

ROOT = os.path.dirname(common.ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_names_and_units_use_allowed_characters():
    b = bench()
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]] + \
        [w["config"] for w in b["workloads"]] + \
        [w["traffic"] for w in b["workloads"]] + \
        [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    units = [m["unit"] for m in b["end_to_end"] + b["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [x["name"] for x in b[group]]
        assert len(group_names) == len(set(group_names))


def test_every_cell_finds_its_files_by_name():
    b = bench()
    here = common.ROOT
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"] == "portbench/configs/{}.json".format(c["name"])
    for w in b["workloads"]:
        traffic = common.load_json("traffic", w["traffic"] + ".json")
        assert os.path.isfile(os.path.join(here, "drivers",
                                           traffic["driver"] + ".py"))
        assert os.path.isfile(os.path.join(here, "limits",
                                           w["name"] + ".json"))
        e2e = [m["name"] for m in b["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert set(e2e) - {"setup_s"} <= set(traffic["e2e"])
    moved = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(here, "metrics",
                                           m["name"] + ".py"))
        assert m["moves"] in moved


@pytest.mark.parametrize("size", [64, 76])
@pytest.mark.parametrize("backbone", ["b0", "b3"])
@pytest.mark.parametrize("config", ["efficientlab-b0-meta",
                                    "efficientlab-b0-joint1000"])
def test_forward_flops_agree_with_the_flop_counter(config, backbone, size):
    """The shipped configurations, and each on EfficientNet-b3, float32, at
    most 17 channels out; at 76^2 the planes go odd. The program's forward
    is counted too, so that a count the reference and counts.py shared
    could not hide a mistake."""
    cfg = common.load_json("configs", config + ".json")
    model = dict(cfg["model"], compute_dtype="float32",
                 n_classes=min(cfg["model"]["n_classes"], 16),
                 **(B3 if backbone == "b3" else {}))
    cfg = dict(cfg, model=model)
    arch = Arch.from_config(cfg)
    images = torch.rand(2, size, size, 3) * 255
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        Forward(arch, make_weights(arch, torch.Generator().manual_seed(0),
                                   "cpu"), False)(images)
    with FlopCounterMode(display=False) as fp, torch.no_grad():
        common.program_model(cfg, "cpu")(images, train=False)
    want = 2 * counts.forward_flops(arch, size, size)
    assert fc.get_total_flops() == want
    assert fp.get_total_flops() == want


def test_meta_flops_match_the_jax_cost_analysis_within_a_few_percent():
    arch = Arch.from_config(common.load_json(
        "configs", "efficientlab-b0-meta.json"))
    step = counts.training_flops(arch, 224, 224, 8)
    assert abs(step / 97.7e9 - 1) < 0.05   # bench.py's XLA count


def test_kernel_bytes_agree_with_the_tensors_sizes():
    b, h, w = 3, 10, 12
    planar = torch.zeros(b, 5, h, w)
    draws = [torch.zeros(b, dtype=torch.int32),
             torch.zeros(b, 6, dtype=torch.int32),
             torch.zeros(b, dtype=torch.int32),
             torch.zeros(b, 4, dtype=torch.int32)]
    size = lambda t: t.numel() * t.element_size()  # noqa: E731
    assert counts.full_pass_bytes(b, h, w) == 2 * size(planar) + sum(
        size(d) for d in draws)
    images, labels = torch.zeros(b, h, w, 3), torch.zeros(b, h, w)
    seeds = torch.zeros(b, dtype=torch.int32)
    assert counts.light_augment_bytes(b, h, w) == \
        2 * (size(images) + size(labels)) + size(seeds)


def made_up_trace():
    # Two streams: kernels overlapping on [10, 20) and [15, 30); a copy
    # inside; idle [30, 50) and [60, 100) of a 100 us slice.
    device = [("k_a", 10.0, 20.0), ("k_b", 15.0, 30.0),
              ("Memcpy HtoD", 16.0, 18.0), ("full_pass_kernel", 50.0, 60.0)]
    host = [("aten::outer", 0.0, 100.0), ("aten::inner", 35.0, 45.0),
            ("aten::late", 65.0, 95.0)]
    return common.Trace(device=device, host=host, wall_s=100e-6,
                        inner_steps=2, augment_batch=4, image_size=8,
                        window_flops=67e12, window_s=2.0,
                        compute="float32")


def test_idle_share_takes_the_union_of_overlapping_kernels():
    t = made_up_trace()
    assert common.union_us([(s, e) for _, s, e in t.device]) == 30.0
    assert math.isclose(readers.idle_pct(t), 70.0)
    assert readers.launches_per_inner_step(t) == 1.5
    assert math.isclose(readers.step_mfu_pct(t), 50.0)
    least = counts.full_pass_bytes(4, 8, 8) / counts.PEAKS["hbm_bytes_per_s"]
    assert math.isclose(readers.roofline_pct(
        t, "full_pass_kernel", lambda b, s: counts.full_pass_bytes(b, s, s)),
        100 * least / 10e-6)
    assert readers.roofline_pct(t, "absent", lambda b, s: 1) is None
    assert common.breakdown(t)["idle_gaps"] == [["aten::inner", 20e-6]]
    assert common.breakdown(t)["device_ops"][0][0] == "k_b"
    # The gaps come from the slice profiled with the host's ops, where
    # given; the device ops from the first.
    named = common.Trace(device=[("k_a", 0.0, 60.0), ("k_b", 100.0, 110.0)],
                         host=t.host, wall_s=110e-6, inner_steps=2,
                         augment_batch=4, image_size=8)
    both = common.breakdown(t, named)
    assert both["idle_gaps"] == [["aten::late", 40e-6]]
    assert both["device_ops"] == common.breakdown(t)["device_ops"]


def test_forbidden_modules_compares_whole_top_level_names():
    found = common.forbidden_modules([
        "jax", "jax.numpy", "mliis_tpu", "mliis_tpu.models", "optax",
        "mliis_tpu_torch", "mliis_tpu_torch.meta", "jaxtyping", "flaxen"])
    assert found == ["jax", "jax.numpy", "mliis_tpu", "mliis_tpu.models",
                     "optax"]


def test_the_reference_imports_nothing_of_the_program():
    here = os.path.join(common.ROOT, "reference")
    for name in os.listdir(here):
        if name.endswith(".py"):
            with open(os.path.join(here, name)) as f:
                text = f.read()
            assert "mliis_tpu" not in re.sub(r'"""[\s\S]*?"""', "", text)
