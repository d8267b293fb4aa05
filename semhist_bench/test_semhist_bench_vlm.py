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
        # a GQA press picks positions for each KV head: the press_heads a
        # reference of this model declares
        press_heads = port.cfg.num_kv_heads
        assert stk.vlm.kept[0].shape == (vlmdraw.JUDGED_ROWS,
                                         stk.kvstore.cache_len,
                                         press_heads)
        stack.record_cache(stk.kvstore, stk.vlm)
        assert [set(c) for c in stk.vlm.cache] == \
            [set(c) for c in stk.kvstore.cache]
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


# A latent-cache VLM as a later configuration would bring it: one press
# head, and a cache of two named parts a position, ``ckv`` and ``krope``
LATENT_STUB = """
import math

import torch

f32 = torch.float32
SERVED = torch.bfloat16
WIDTHS = dict(layers=2, d=64, patches=8, vocab=256, latent=32, rope=8,
              press_heads=1)


def widths(smoke):
    return WIDTHS


def layout(smoke):
    w = WIDTHS
    out = [("embed", (w["vocab"], w["latent"]), "normal", SERVED),
           ("head", (w["latent"], w["vocab"]), "normal", SERVED)]
    return out + [(f"layers.{i}.wkv", (w["d"], w["latent"] + w["rope"]),
                   "normal", SERVED) for i in range(w["layers"])]


def forward(weights, patches, calib, *, smoke, rate, kept=None,
            prompts=(), low=None, seen=None):
    w = WIDTHS
    r = (lambda t: t) if low is None else (lambda t: t.to(low).to(f32))
    top = {k: r(t.to(f32)) for k, t in weights("top").items()}
    x = patches.to(f32)
    N, P, _ = x.shape
    keep = max(1, math.ceil(P * (1.0 - rate)))
    own, pooled = [], torch.zeros((N, w["latent"]), device=x.device)
    for i in range(w["layers"]):
        lat = r(x) @ r(weights(f"layers.{i}")[f"layers.{i}.wkv"].to(f32))
        best = torch.topk(lat[..., :w["latent"]].norm(dim=-1), keep,
                          dim=-1).indices
        own.append(torch.sort(best, dim=-1).values[..., None])
        at = own[-1] if kept is None else torch.as_tensor(kept[i]).long()
        lat = torch.gather(lat, 1, at.expand(-1, -1, lat.shape[-1]))
        parts = {"ckv": lat[..., :w["latent"]],
                 "krope": lat[..., w["latent"]:]}
        if seen is not None:
            seen(i, parts)
        pooled = pooled + parts["ckv"].mean(1)
    logits = [(pooled + top["embed"][torch.as_tensor(p).long()].mean(0))
              @ top["head"] for p in prompts]
    return own, logits
"""
STUB = "latent-stub"
STUB_SAMPLE = 16


def _stub(tmp_path):
    from semhist_bench import vlmcheck

    (tmp_path / "vlm").mkdir(exist_ok=True)
    (tmp_path / "vlm" / f"{STUB}.py").write_text(LATENT_STUB)
    return vlmcheck.reference_module(tmp_path, STUB)


def _stub_kv() -> dict:
    return {"vlm": STUB, "smoke": True,
            "compression_rate": _cfg()["kvbatch"]["compression_rate"],
            "prompt_len": 6}


def _stub_program(ref, seed: int):
    """The stub's "program": its own forward over the whole sample, its
    cache served in bfloat16 in a store of (B, slots, ...) parts a layer,
    and the record a run would take of the judged rows."""
    import types

    import numpy as np

    from semhist_bench import vlmcheck, vlmdraw

    kv = _stub_kv()
    embs = np.random.default_rng(seed).standard_normal(
        (STUB_SAMPLE, 24)).astype(np.float32)
    inp = vlmcheck.draw_inputs(ref, True, seed, embs,
                               np.arange(STUB_SAMPLE), "cpu")
    prompt = np.arange(kv["prompt_len"])
    parts = []
    own, logits = ref.forward(inp.weights, inp.patches, inp.calib,
                              smoke=True, rate=kv["compression_rate"],
                              prompts=[prompt],
                              seen=lambda i, p: parts.append(p))
    keep = own[0].shape[1]
    cache = []
    for layer in parts:
        bufs = {}
        for name, t in layer.items():
            bufs[name] = torch.zeros((STUB_SAMPLE, keep + 2, *t.shape[2:]),
                                     dtype=torch.bfloat16)
            bufs[name][:, :keep] = t
        cache.append(bufs)
    store = types.SimpleNamespace(cache=cache, cache_len=keep)
    rows = vlmdraw.judged_rows(seed, STUB_SAMPLE)
    rec = vlmcheck.VLMRecord(
        rows=rows, kept=[k[torch.as_tensor(rows)].numpy() for k in own],
        decodes=[(prompt, logits[0][torch.as_tensor(rows)].numpy())])
    return kv, embs, store, rec


def _stub_judge(ref, seed, alter=None):
    from semhist_bench import stack, vlmcheck

    kv, embs, store, rec = _stub_program(ref, seed)
    if alter is not None:
        alter(store, rec)
    stack.record_cache(store, rec)
    return vlmcheck.judge(ref, kv, seed, embs, rec, "cpu"), rec


def test_a_latent_cache_is_recorded_and_judged_by_its_parts(tmp_path):
    """A store whose layers hold ``ckv`` and ``krope`` is recorded part by
    part and judged within the cell's limits: only bfloat16's rounding
    of the cache parts moves a number."""
    from semhist_bench import vlmcheck, vlmdraw

    ref = _stub(tmp_path)
    nums, rec = _stub_judge(ref, SEED)
    J, keep = vlmdraw.JUDGED_ROWS, rec.kept[0].shape[1]
    assert [{n: tuple(t.shape) for n, t in c.items()} for c in rec.cache] \
        == [{"ckv": (J, keep, 32), "krope": (J, keep, 8)}] * 2
    limits = _limits()
    for k, v in nums.items():
        assert 0.0 <= v < vlmcheck.NO_READING and v <= limits[k], (k, v)
    assert 0.0 < nums["vlm_cache_gap"] < 0.01


def _zero_ckv_row(store, rec):
    for c in store.cache:
        c["ckv"][int(rec.rows[0])] = 0


def _planted(name):
    def alter(store, rec):
        from semhist_bench import vlmfaults

        with vlmfaults.planted(name) as after_build:
            after_build(store, rec.rows)
    return alter


@pytest.mark.parametrize("alter", [
    _zero_ckv_row, _planted("cache_row_perturbed"),
    _planted("cache_position_overwritten")],
    ids=["ckv_row_zeroed", "cache_row_perturbed",
         "cache_position_overwritten"])
def test_a_broken_latent_cache_fails_the_cache_gap(tmp_path, alter):
    """A judged row's ``ckv`` left at zero, and ``vlmfaults``' two cache
    faults acting on every part of a latent layer, fail
    ``vlm_cache_gap``."""
    nums, _ = _stub_judge(_stub(tmp_path), SEED + 1, alter)
    assert nums["vlm_cache_gap"] > _limits()["vlm_cache_gap"], nums
    assert nums["vlm_keep_gap"] <= _limits()["vlm_keep_gap"], nums


def _renamed(store, rec):
    for c in store.cache:
        c["k_rope"] = c.pop("krope")


def _dropped(store, rec):
    for c in store.cache:
        del c["krope"]


def _extra(store, rec):
    for c in store.cache:
        c["scale"] = torch.ones_like(c["krope"])


@pytest.mark.parametrize("alter", [_renamed, _dropped, _extra],
                         ids=["renamed", "dropped", "extra"])
def test_a_cache_of_other_parts_than_the_reference_names_is_not_correct(
        tmp_path, alter):
    """A store whose layers hold other parts than the reference names
    reads ``NO_READING`` and fails ``correct``, without raising."""
    from semhist_bench import vlmcheck

    nums, _ = _stub_judge(_stub(tmp_path), SEED + 2, alter)
    limits = _limits()
    assert nums["vlm_cache_gap"] == vlmcheck.NO_READING
    assert not all(v <= limits[k] for k, v in nums.items())
    assert nums["vlm_keep_gap"] <= limits["vlm_keep_gap"]


def test_kept_positions_for_other_press_heads_read_nothing(tmp_path):
    """Kept positions whose last axis is not the reference's
    ``press_heads`` are not usable: the press and the cache read
    ``NO_READING``."""
    from semhist_bench import vlmcheck

    def two_heads(store, rec):
        rec.kept = [k.repeat(2, axis=2) for k in rec.kept]

    nums, _ = _stub_judge(_stub(tmp_path), SEED + 3, two_heads)
    assert nums["vlm_keep_gap"] == vlmcheck.NO_READING
    assert nums["vlm_cache_gap"] == vlmcheck.NO_READING


def test_the_latent_control_reads_its_parts(tmp_path):
    """The control puts the reference in the program's place part by
    part: its cache, recorded by name, reads a finite gap above the
    sound one."""
    from semhist_bench import vlmcheck

    ref = _stub(tmp_path)
    kv, embs, _, _ = _stub_program(ref, SEED + 4)
    sound, _ = _stub_judge(ref, SEED + 4)
    nums = vlmcheck.control_readings(ref, kv, SEED + 4, embs, "cpu")
    assert all(v < vlmcheck.NO_READING for v in nums.values()), nums
    assert nums["vlm_cache_gap"] > 3.0 * sound["vlm_cache_gap"], \
        (nums, sound)


def test_the_llava_reference_names_its_parts_and_press_heads():
    """llava's press picks positions for each of its KV heads, and the
    reference hands over its cache as the parts ``k`` and ``v``, each
    (N, keep, press heads, head_dim)."""
    import numpy as np

    from semhist_bench import stack, vlmcheck

    ref = vlmcheck.reference_module(BENCH, "llava-next-8b")
    for smoke in (True, False):
        w = ref.widths(smoke)
        assert w["press_heads"] == w["kv_heads"]
    port = stack.port_vlm(_cfg()["kvbatch"])
    w = ref.widths(True)
    assert w["press_heads"] == port.cfg.num_kv_heads
    embs = np.random.default_rng(SEED).standard_normal(
        (STUB_SAMPLE, 24)).astype(np.float32)
    inp = vlmcheck.draw_inputs(ref, True, SEED, embs, np.arange(3), "cpu")
    parts = []
    own, _ = ref.forward(inp.weights, inp.patches, inp.calib, smoke=True,
                         rate=0.6, seen=lambda i, p: parts.append(p))
    keep = own[0].shape[1]
    assert [{n: tuple(t.shape) for n, t in p.items()} for p in parts] == \
        [{"k": (3, keep, w["press_heads"], w["head_dim"]),
          "v": (3, keep, w["press_heads"], w["head_dim"])}] * w["layers"]
