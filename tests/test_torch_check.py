"""The model checker of the port (``tpu_aggcomm_torch/analysis/check.py``)
against the reference's, on the CPU.

For every method at n=8 a=3 and n=32 a=8, healthy and repaired under
``deadlink:5>3`` and ``slow:r2*4``, both packages' sweeps give the same
verdict, refuted properties and reason text, and each method's whole
report (every property, witness and config) is the reference's. The
seeded defects of ``tests/test_analysis.py`` (a dropped IRECV, swapped
recv WAITALLs, a cyclic ISSEND wait, an unrepaired dead link) give the
reference's REFUTED reports and its rendering, and the port's ``local``
oracle deadlocks on each, as the reference's does.
"""

import copy
import json

import pytest

pytest.importorskip("jax")

from tpu_aggcomm.analysis import check as ref_check  # noqa: E402
from tpu_aggcomm.core.methods import compile_method as ref_compile  # noqa: E402
from tpu_aggcomm.core.pattern import AggregatorPattern as RefPattern  # noqa: E402
from tpu_aggcomm.core.schedule import OpKind as RefOpKind  # noqa: E402
from tpu_aggcomm.faults import RepairError as RefRepairError  # noqa: E402
from tpu_aggcomm.faults import parse_fault as ref_parse_fault  # noqa: E402
from tpu_aggcomm.faults import repair_schedule as ref_repair  # noqa: E402

from tpu_aggcomm_torch.analysis import check  # noqa: E402
from tpu_aggcomm_torch.backends.local import (DeadlockError,  # noqa: E402
                                              run_schedule_local)
from tpu_aggcomm_torch.core.methods import METHODS, compile_method  # noqa: E402
from tpu_aggcomm_torch.core.pattern import AggregatorPattern  # noqa: E402
from tpu_aggcomm_torch.core.schedule import OpKind  # noqa: E402
from tpu_aggcomm_torch.faults import (RepairError, parse_fault,  # noqa: E402
                                      repair_schedule)

SHAPES = [(8, 3, 4), (32, 8, 4)]          # (nprocs, cb_nodes, comm_size)
FAULTS = [None, "deadlink:5>3", "slow:r2*4"]


def _json(x):
    return json.loads(json.dumps(x))


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_sweep_verdicts_and_reasons_match_the_reference(shape, fault):
    n, a, c = shape
    got = check.check_sweep(n, a, c, data_size=64, fault=fault)
    want = ref_check.check_sweep(n, a, c, data_size=64, fault=fault)
    assert _json(got) == _json(want)
    assert len(got) == len(METHODS)
    assert not [r for r in got if r["verdict"] == "REFUTED"]
    assert check.render_check_sweep(got, n, a, c, fault=fault) == \
        ref_check.render_check_sweep(want, n, a, c, fault=fault)


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_every_dispatched_report_matches_the_reference(shape, fault):
    n, a, c = shape
    kw = dict(data_size=64, comm_size=c)
    for m, info in sorted(METHODS.items()):
        if not info.dispatched:
            continue
        s = compile_method(m, AggregatorPattern(n, a, **kw))
        rs = ref_compile(m, RefPattern(n, a, **kw))
        if fault:
            try:
                want_s = ref_repair(rs, fault)
            except RefRepairError as e:      # the repair's named refusal
                with pytest.raises(RepairError) as got_e:
                    repair_schedule(s, fault)
                assert str(got_e.value) == str(e)
                continue
            s, rs = repair_schedule(s, fault), want_s
        got, want = check.check_schedule(s), ref_check.check_schedule(rs)
        assert _json(got) == _json(want), m
        assert check.render_check(got) == ref_check.render_check(want)


def _sched(pkg_compile, pattern, method=1, n=8, a=3):
    return copy.deepcopy(pkg_compile(method, pattern(
        n, a, data_size=64, comm_size=4)))


def _drop_irecv(s, kind):
    prog = s.programs[0]
    del prog[next(i for i, o in enumerate(prog) if o.kind is kind.IRECV)]


def _swap_waitalls(s, kind):
    prog = s.programs[0]
    w = [i for i, o in enumerate(prog) if o.kind is kind.WAITALL
         and any(prog[t].kind is kind.IRECV for t in o.tokens)]
    prog[w[0]].tokens, prog[w[1]].tokens = (prog[w[1]].tokens,
                                            prog[w[0]].tokens)


def _cyclic_issend(s, kind):
    prog = s.programs[0]
    sw = next(i for i, o in enumerate(prog) if o.kind is kind.WAITALL
              and all(prog[t].kind is kind.ISSEND for t in o.tokens))
    first_ir = next(i for i, o in enumerate(prog) if o.kind is kind.IRECV)
    prog.insert(first_ir, prog.pop(sw))


@pytest.mark.parametrize("defect,refuted,needle", [
    (_drop_irecv, {"deadlock_freedom", "conservation"},
     "no matching receive posted"),
    (_swap_waitalls, {"deadlock_freedom"}, "waits-for cycle"),
    (_cyclic_issend, {"deadlock_freedom"}, "waits-for cycle"),
])
def test_seeded_defects_match_the_reference(defect, refuted, needle):
    s = _sched(compile_method, AggregatorPattern)
    rs = _sched(ref_compile, RefPattern)
    defect(s, OpKind)
    defect(rs, RefOpKind)
    got, want = check.check_schedule(s), ref_check.check_schedule(rs)
    assert _json(got) == _json(want)
    assert got["verdict"] == "REFUTED"
    bad = {k for k, v in got["properties"].items()
           if v["verdict"] == "REFUTED"}
    assert refuted <= bad
    assert needle in got["properties"]["deadlock_freedom"]["detail"]
    assert check.render_check(got) == ref_check.render_check(want)
    with pytest.raises(DeadlockError):
        run_schedule_local(s)


def test_unrepaired_dead_link_is_refuted_like_the_reference():
    s = _sched(compile_method, AggregatorPattern, n=32, a=8)
    rs = _sched(ref_compile, RefPattern, n=32, a=8)
    s.fault = parse_fault("deadlink:17>0").canonical()
    rs.fault = ref_parse_fault("deadlink:17>0").canonical()
    got, want = check.check_schedule(s), ref_check.check_schedule(rs)
    assert _json(got) == _json(want) and got["verdict"] == "REFUTED"
    assert "17>0" in got["properties"]["deadlock_freedom"]["detail"]
    with pytest.raises(DeadlockError):
        run_schedule_local(s)


def test_artifact_writer_matches_the_reference(tmp_path):
    s = _sched(compile_method, AggregatorPattern)
    rep = check.check_schedule(s)
    assert rep["schema"] == ref_check.CHECK_SCHEMA == check.CHECK_SCHEMA
    path = check.write_artifact(str(tmp_path / "CHECK_m1.json"), rep)
    ref_path = ref_check.write_artifact(str(tmp_path / "ref.json"), rep)
    assert open(path).read() == open(ref_path).read()
