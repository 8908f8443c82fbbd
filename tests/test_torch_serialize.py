"""The port's wire format (``repro_torch.core.serialize``) against the
reference's (``repro.core.serialize``), on the CPU.

  * a port result round-trips through JSON bit-exactly (dtypes too);
  * a blob the reference wrote loads in the port to the same arrays, and
    a blob the port wrote loads in the reference: the format is one;
  * configs and scenarios cross both ways, to equal dataclasses and
    arrays;
  * ``merge_sweepresults`` gathers shards back into the one-launch
    result bit for bit, as the reference's does.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as R                                       # noqa: E402
from repro.core import serialize as SR                       # noqa: E402
from repro_torch import core as P                            # noqa: E402
from repro_torch.core import serialize as SP                 # noqa: E402
from repro_torch.core import simulator as simP               # noqa: E402

N_STEPS = 300
TRACE = ("times", "delivered", "rate", "inst_thr", "max_q", "n_paused",
         "marked", "cnp", "n_nonmin", "ctrl", "pause_time", "vc_stall")


def _wire(d: dict) -> dict:
    return json.loads(json.dumps(d))


def _leaves(res):
    """(name, numpy array) of a SimResult's traces and final state."""
    for f in TRACE:
        v = getattr(res, f)
        yield f, None if v is None else np.asarray(v)
    for f in res.final._fields:
        v = getattr(res.final, f)
        if isinstance(v, dict):
            for k in sorted(v):
                yield f"final.cc.{k}", np.asarray(v[k])
        else:
            yield f"final.{f}", np.asarray(v)


def _assert_same(a, b):
    for (na, x), (nb, y) in zip(_leaves(a), _leaves(b), strict=True):
        assert na == nb
        if x is None:
            assert y is None, na
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, na
        np.testing.assert_array_equal(x, y, err_msg=na)
    assert a.trace_every == b.trace_every


@pytest.fixture(scope="module")
def port_result():
    cfg = P.PAPER_CONFIG
    scn = P.ScenarioSpec.incast(3).build(cfg)
    return simP.run(scn, cfg, n_steps=N_STEPS, device="cpu")


@pytest.fixture(scope="module")
def ref_result():
    cfg = R.PAPER_CONFIG
    return R.run(R.ScenarioSpec.incast(3).build(cfg), cfg, n_steps=N_STEPS)


@pytest.fixture(scope="module")
def port_sweep():
    return P.Sweep([("a", P.CCSpec(), P.ScenarioSpec.incast(3)),
                    ("b", P.CCSpec(reaction="rp"),
                     P.ScenarioSpec.incast(4))]).run(n_steps=N_STEPS,
                                                     device="cpu")


def test_array_codec_preserves_dtype():
    for a in (np.arange(6, dtype=np.int32).reshape(2, 3),
              np.float32([[1.5, -0.0]]), np.int32(7).reshape(()),
              np.float64([np.inf]), torch.arange(4, dtype=torch.int32)):
        d = _wire(SP.encode_array(a))
        assert d == _wire(SR.encode_array(np.asarray(a)))
        b = SP.decode_array(d)
        a = np.asarray(a)
        assert b.dtype == a.dtype and b.shape == a.shape
        np.testing.assert_array_equal(a, b)


def test_port_simresult_roundtrip_bitexact(port_result):
    back = P.SimResult.from_dict(_wire(port_result.to_dict()))
    _assert_same(port_result, back)
    assert np.asarray(back.final.t).dtype == np.int32
    rerun = simP.run(back.scn, back.cfg, n_steps=N_STEPS, device="cpu")
    np.testing.assert_array_equal(rerun.delivered, port_result.delivered)
    with pytest.raises(ValueError, match="trace"):
        P.SimResult.from_dict(_wire(port_result.to_dict(traces=False)))
    dec = _wire(port_result.to_dict(decimate=4))
    np.testing.assert_array_equal(SP.decode_array(dec["delivered"]),
                                  port_result.delivered[3::4])


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_simresult_blobs_cross_packages(direction, port_result,
                                        ref_result):
    """A blob one package wrote loads in the other to the same arrays
    (and the same summary)."""
    if direction == "ref_to_port":
        src, back = ref_result, P.SimResult.from_dict(
            _wire(ref_result.to_dict()))
        assert type(back.cfg) is type(P.PAPER_CONFIG)
    else:
        src, back = port_result, R.SimResult.from_dict(
            _wire(port_result.to_dict()))
        assert type(back.cfg) is type(R.PAPER_CONFIG)
    _assert_same(src, back)
    for k, v in src.summary().items():
        np.testing.assert_equal(back.summary()[k], v, err_msg=k)


def test_sweepresult_roundtrip_and_cross_packages(port_sweep):
    back = P.SweepResult.from_dict(_wire(port_sweep.to_dict()))
    assert back.names == port_sweep.names
    for name, res in port_sweep.items():
        _assert_same(res, back[name])
    ref = R.SweepResult.from_dict(_wire(port_sweep.to_dict()))
    for name, res in port_sweep.items():
        _assert_same(res, ref[name])
    again = P.SweepResult.from_dict(_wire(ref.to_dict()))
    for name, res in port_sweep.items():
        _assert_same(res, again[name])


def _shard(res, idx):
    """Runs ``idx`` of a SweepResult as a SweepResult of their own."""
    take = lambda x: np.asarray(x)[idx]                      # noqa: E731
    fin = res.final
    final = type(fin)(**{f: ({k: take(v) for k, v in fin.cc.items()}
                             if f == "cc" else take(getattr(fin, f)))
                         for f in fin._fields})
    tr = type(res.traces)(*[None if v is None else take(v)
                            for v in res.traces])
    return type(res)(points=[res.points[i] for i in idx], times=res.times,
                     traces=tr, final=final, trace_every=res.trace_every)


def test_merge_sweepresults_gathers_shards_bitwise(port_sweep):
    parts = [_shard(port_sweep, [1]), _shard(port_sweep, [0])]
    merged = SP.merge_sweepresults(parts, points=port_sweep.points)
    for name, res in port_sweep.items():
        _assert_same(res, merged[name])
    # the reference's merge of the same shards (carried over the wire)
    # gives the same arrays
    rparts = [R.SweepResult.from_dict(_wire(p.to_dict())) for p in parts]
    rmerged = SR.merge_sweepresults(rparts)
    pmerged = SP.merge_sweepresults(parts)
    assert [p.name for p in rmerged.points] == pmerged.names
    for name, res in pmerged.items():
        _assert_same(res, rmerged[name])
    with pytest.raises(ValueError, match="two shards"):
        SP.merge_sweepresults([parts[0], parts[0]])


@pytest.mark.parametrize("which", ["spec", "legacy"])
def test_configs_cross_packages(which):
    if which == "spec":
        port = P.CCSpec(reaction="swift").replace(
            rev=dataclasses.replace(P.CCSpec().rev, erp_settle=0.93))
        ref = R.CCSpec(reaction="swift").replace(
            rev=dataclasses.replace(R.CCSpec().rev, erp_settle=0.93))
    else:
        port, ref = P.PAPER_CONFIG, R.PAPER_CONFIG
    d = _wire(SP.config_to_dict(port))
    assert d == _wire(SR.config_to_dict(ref))
    assert SP.config_from_dict(d) == port
    assert SR.config_from_dict(d) == ref
    assert SP.config_from_dict(_wire(SR.config_to_dict(ref))) == port


@pytest.mark.parametrize("kind", ["multipath", "vc_victim"])
def test_scenarios_cross_packages(kind):
    if kind == "multipath":
        ref = R.ScenarioSpec.incast(3, n_paths=2).build(R.CCSpec())
    else:
        from repro.core.params import LinkParams
        from repro.core.workloads import hol_victim_incast
        from repro.net import FabricSpec
        cfg = R.CCSpec(link=LinkParams(n_vcs=2))
        wl = dataclasses.replace(hol_victim_incast(4, 64),
                                 vc=(0,) * 4 + (1,))
        ref = wl.spec(fabric=FabricSpec.clos3(4)).build(cfg)
    port = SP.scenario_from_dict(_wire(SR.scenario_to_dict(ref)))
    assert isinstance(port, P.Scenario)
    assert _wire(SP.scenario_to_dict(port)) == \
        _wire(SR.scenario_to_dict(ref))
    for f, v in zip(ref._fields, ref):
        w = getattr(port, f)
        if v is None:
            assert w is None, f
        elif isinstance(v, (int, float)):
            assert w == v, f
        else:
            assert np.asarray(w).dtype == np.asarray(v).dtype, f
            np.testing.assert_array_equal(np.asarray(w), np.asarray(v),
                                          err_msg=f)
