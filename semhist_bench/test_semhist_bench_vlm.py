"""The KV-batch VLM in the benchmark: a configuration names the VLM the
port builds, every key of its ``kvbatch`` group is read by something, the
VLM is judged against the plain reference of its name, and the check
fails what it has to fail."""

import json
import pathlib
import time

import pytest

torch = pytest.importorskip("torch")

from semhist_bench.conftest import TINY  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
CELL = "wildlife-8m.open-mixed"
SEED = 6_123_456_789


def _cell():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    return bench, {w["name"]: w for w in bench["workloads"]}[CELL]


def _cfg(kv: dict | None = None) -> dict:
    from semhist_bench.inputs import merge

    cfg = json.loads((BENCH / "configs" / "wildlife-8m.json").read_text())
    return merge(merge(cfg, TINY), {"kvbatch": kv or {}})


def _run(kv: dict | None = None, seed: int = SEED, fault=None):
    from semhist_bench import harness

    bench, cell = _cell()
    return harness.run_cell(BENCH, bench, cell, seed=seed, seconds=1.0,
                            trace=False, device="cpu",
                            t_start=time.perf_counter(),
                            overrides=dict(TINY, kvbatch=dict(
                                TINY["kvbatch"], **(kv or {}))),
                            fault=fault)


def _limits() -> dict:
    return json.loads((BENCH / "limits" / f"{CELL}.json").read_text())


def test_a_configuration_names_the_vlm_the_port_builds():
    """``kvbatch.vlm`` decides the model: a configuration naming another
    registered VLM builds it through the unedited harness, from the
    benchmark's own draws."""
    from semhist_bench import inputs, stack, vlmdraw

    cfg = _cfg({"vlm": "qwen25-vl-7b"})
    dev = torch.device("cpu")
    tree, store, params, sample = inputs.build_inputs(cfg, SEED, dev)
    stk = stack.build(cfg, tree, store, store.numpy(), params, sample, SEED,
                      stack.Spans())
    try:
        assert stk.kvstore.cfg.name == "qwen25-vl-smoke"
        port = stack.port_vlm(cfg["kvbatch"])
        lay = stack.vlm_layout(port.cfg)
        drawn = {}
        for g in vlmdraw.groups(lay):
            drawn.update(vlmdraw.draw_group(lay, SEED, g, dev))
        assert torch.equal(stk.kvstore.params["layers"][1]["mixer"]["wq"],
                           drawn["layers.1.mixer.wq"])
        assert len(stk.vlm.kept) == port.cfg.num_layers
        assert stk.vlm.kept[0].shape == (vlmdraw.JUDGED_ROWS,
                                         stk.kvstore.cache_len,
                                         port.cfg.num_kv_heads)
    finally:
        stk.unwrap()
        stk.close()


def test_an_unknown_kvbatch_key_stops_the_run():
    from semhist_bench import stack

    with pytest.raises(ValueError, match="cache_layout"):
        stack.port_vlm(dict(_cfg()["kvbatch"], cache_layout="latent"))
    with pytest.raises(ValueError, match="cache_layout"):
        _run({"cache_layout": "latent"})


def test_every_kvbatch_key_reaches_what_reads_it():
    from semhist_bench import stack

    port = stack.port_vlm(dict(_cfg()["kvbatch"], run_machinery=False))
    assert port.store_kw == {"rate": 0.6}
    assert port.estimator_kw == {"prompt_len": 6, "run_machinery": False}
    assert port.cfg.name == "llava-next-8b-smoke"


def test_a_vlm_without_a_reference_stops_the_run():
    with pytest.raises(FileNotFoundError, match="qwen25-vl-7b"):
        _run({"vlm": "qwen25-vl-7b"})


def test_a_program_layout_the_reference_does_not_have_stops_the_run():
    from semhist_bench import stack, vlmcheck

    ref = vlmcheck.reference_module(BENCH, "llava-next-8b")
    port = stack.port_vlm(_cfg()["kvbatch"])
    lay = stack.vlm_layout(port.cfg)
    vlmcheck.check_layout(ref, True, lay)
    with pytest.raises(ValueError, match="layers.1.mixer.wq"):
        vlmcheck.check_layout(ref, True, [
            (p, (s[0], s[1] + 1, s[2]) if p == "layers.1.mixer.wq" else s,
             i, d) for p, s, i, d in lay])


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_the_llava_reference_agrees_with_the_port(seed):
    """The port's llava-next-8b at smoke size, built and decoded as a run
    does, within the cell's limits of the reference."""
    from semhist_bench import vlm_readings

    _, cell = _cell()
    out = vlm_readings.readings(BENCH, cell, seed, "cpu", TINY)
    limits = _limits()
    assert set(out["numbers"]) == {"vlm_keep_gap", "vlm_cache_gap",
                                   "vlm_logit_gap"}
    for k, v in out["numbers"].items():
        assert v <= limits[k], (k, v)
    assert out["numbers"]["vlm_logit_gap"] > 0.0
    assert out["numbers"]["vlm_cache_gap"] > 0.0


@pytest.mark.parametrize("plant", ["cache_row_perturbed",
                                   "cache_position_overwritten",
                                   "layer_attention_skipped",
                                   "decode_attention_skipped",
                                   "press_unchanged"])
def test_a_broken_vlm_is_not_correct(plant):
    """``vlmfaults``' faults, planted under a run at smoke size, fail a
    VLM number and nothing else. Not here: ``decode_heads_misrouted``,
    which moves the logits of a model of two KV heads of 16 too little;
    at the cell's size it fails and the last layer's skipped attention
    passes (PERF.md §2)."""
    from semhist_bench import vlmfaults

    with vlmfaults.planted(plant) as after_build:
        result, checks = _run(
            fault=lambda stk: after_build(stk.kvstore, stk.vlm.rows))
    assert not result["correct"]
    bad = {k for k, c in checks.items() if c["value"] > c["limit"]}
    assert bad and bad <= {"vlm_keep_gap", "vlm_cache_gap",
                           "vlm_logit_gap"}, checks


def test_a_vlm_that_never_decodes_is_not_correct():
    result, checks = _run({"run_machinery": False})
    assert not result["correct"]
    assert checks["vlm_logit_gap"]["value"] > checks["vlm_logit_gap"]["limit"]


@pytest.mark.parametrize("seed", [SEED + 2, SEED + 3])
def test_the_vlm_control_is_not_correct(seed):
    """The reference in float8 e4m3 in the program's place. The cell's
    limits are set at its own size, where the control fails all three
    (PERF.md §2); at this size every number is smaller, so the control is
    held to what a limit needs there: three times the program's reading
    on the same seed, on at least one number."""
    from semhist_bench import control, vlm_readings

    _, cell = _cell()
    nums = control.vlm_readings(BENCH, cell, seed, "cpu", TINY)
    sound = vlm_readings.readings(BENCH, cell, seed, "cpu",
                                  TINY)["numbers"]
    assert set(nums) == set(sound) == {"vlm_keep_gap", "vlm_cache_gap",
                                       "vlm_logit_gap"}
    assert any(nums[k] > 3.0 * sound[k] for k in nums), (nums, sound)
    assert nums["vlm_logit_gap"] > 3.0 * sound["vlm_logit_gap"]
