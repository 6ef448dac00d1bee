"""The dependency levels the card's JODIE kernel walks
(smore_tpu_torch/ops/jodie_epoch.py ``scan_levels``, host C++, and its numpy
twin ``scan_levels_np``).

On random and adversarial events (all on one user, all on one item,
neg == i everywhere, none, one): the C++ function equals the twin; the
levels partition the events, keep each level in time order, touch disjoint
rows within a level, give every row its events in time order, and are the
earliest possible (an event past level 1 shares a row with an event of the
level before). The plain loop replayed level by level, events permuted by
the schedule, leaves the sequential loop's tables bit for bit, so the
kernel's walk changes only the loss's summation order. ``jodie_epoch``
refuses a schedule whose shape or levels do not fit its events, and the
CPU path neither needs one nor builds one."""

import numpy as np
import pytest
import torch

from smore_tpu_torch.models import jodie as jodie_model
from smore_tpu_torch.models.jodie import JODIE
from smore_tpu_torch.ops.jodie_epoch import (
    LevelSchedule,
    jodie_epoch,
    jodie_epoch_ref,
    level_schedule,
    scan_levels,
    scan_levels_np,
)

torch.set_num_threads(1)


def _random(seed, T=3000, U=40, I=60):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, U, T), rng.integers(0, I, T),
            rng.integers(0, I, T), U, I)


def _cases():
    rng = np.random.default_rng(7)
    T = 500
    i = rng.integers(0, 30, T)
    return {
        "random": _random(0),
        "random_skewed": (rng.zipf(1.5, T) % 25, rng.zipf(1.3, T) % 30,
                          rng.integers(0, 30, T), 25, 30),
        "one_user": (np.zeros(T, int), rng.integers(0, 30, T),
                     rng.integers(0, 30, T), 1, 30),
        "one_item": (rng.integers(0, 20, T), np.zeros(T, int),
                     rng.integers(0, 30, T), 20, 30),
        "neg_is_item": (rng.integers(0, 20, T), i, i, 20, 30),
        "empty": (np.zeros(0, int), np.zeros(0, int), np.zeros(0, int), 3, 3),
        "one_event": (np.array([2]), np.array([1]), np.array([1]), 3, 3),
    }


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpp_equals_the_numpy_twin(case):
    uid, iid, negs, U, I = CASES[case]
    order, ptr = scan_levels(uid, iid, negs, U, I)
    o2, p2 = scan_levels_np(uid, iid, negs, U, I)
    assert order.dtype == np.int32 and ptr.dtype == np.int32
    assert np.array_equal(order, o2) and np.array_equal(ptr, p2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_levels_partition_disjoint_ordered_and_earliest(case):
    uid, iid, negs, U, I = CASES[case]
    order, ptr = scan_levels(uid, iid, negs, U, I)
    T = len(uid)
    assert np.array_equal(np.sort(order), np.arange(T))
    assert ptr[0] == 0 and ptr[-1] == T and (np.diff(ptr) > 0).all()
    level = np.empty(T, int)
    for l in range(len(ptr) - 1):
        ev = order[ptr[l]:ptr[l + 1]]
        level[ev] = l
        assert (np.diff(ev) > 0).all(), "a level out of time order"
        assert len(set(uid[ev])) == len(ev), "two events on one user row"
        items = [r for e in ev for r in {iid[e], negs[e]}]
        assert len(set(items)) == len(items), "two events on one item row"
    # every row meets its events in time order, each a level later
    for rows, n in ((uid[:, None], U), (np.stack([iid, negs], 1), I)):
        for r in range(n):
            ev = np.nonzero((rows == r).any(1))[0]
            assert (np.diff(level[ev]) > 0).all()
    # the earliest levels: past level 0, a row shared with the level before
    for e in range(T):
        if level[e]:
            prev = order[ptr[level[e] - 1]:ptr[level[e]]]
            mine = {("u", uid[e]), ("i", iid[e]), ("i", negs[e])}
            assert any(mine & {("u", uid[p]), ("i", iid[p]), ("i", negs[p])}
                       for p in prev)


@pytest.mark.parametrize("case,levels", [("one_user", 500), ("one_item", 500),
                                         ("empty", 0), ("one_event", 1)])
def test_serial_sets_take_one_level_an_event(case, levels):
    uid, iid, negs, U, I = CASES[case]
    order, ptr = scan_levels(uid, iid, negs, U, I)
    assert len(ptr) - 1 == levels
    assert np.array_equal(order, np.arange(len(uid)))


def test_rows_out_of_range_raise():
    uid, iid, negs, U, I = _random(1, T=50)
    for bad in ((uid, iid, negs, U - 1, I), (uid, iid, negs, U, I - 1)):
        with pytest.raises(ValueError, match="out of range"):
            scan_levels(*bad)
    with pytest.raises(ValueError, match="out of range"):
        scan_levels(uid, iid, negs - 1 - negs.max(), U, I)
    with pytest.raises(ValueError, match="one length"):
        scan_levels(uid, iid, negs[:-1], U, I)


def test_tensors_and_arrays_give_one_schedule():
    uid, iid, negs, U, I = _random(2, T=400)
    want = scan_levels(uid, iid, negs, U, I)
    got = scan_levels(*(torch.from_numpy(a) for a in (uid, iid, negs)), U, I)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    s = level_schedule(uid, iid, torch.from_numpy(negs), U, I, "cpu")
    assert torch.equal(s.order, torch.from_numpy(want[0]))
    assert s.n_levels == len(want[1]) - 1
    assert s.max_width == int(np.diff(want[1]).max())


def _model_inputs(tmp_path, dim, features, seed):
    rng = np.random.default_rng(seed)
    t, lines = 0.0, []
    for _ in range(600):
        t += float(rng.random())
        line = f"u{rng.integers(0, 15)} i{rng.integers(0, 12)} {t:.3f}"
        if features:
            line += "".join(f" {x:.3f}" for x in rng.random(3))
        lines.append(line + "\n")
    (tmp_path / "ev.txt").write_text("".join(lines))
    m = JODIE.load_interactions(str(tmp_path / "ev.txt"), device="cpu",
                                seed=seed)
    m.init(dim)
    negs = torch.from_numpy(rng.integers(0, m.ig.n_items, 600))
    assert (negs.numpy() == m.ig.item_ids).any(), "no event with neg == i"
    return m, negs


@pytest.mark.parametrize("dim,features,bce_lr", [(8, True, 0.2),
                                                 (50, False, 0.2),
                                                 (128, True, 0.0)])
def test_levelled_replay_equals_the_sequential_loop_bit_for_bit(
        tmp_path, dim, features, bce_lr):
    m, negs = _model_inputs(tmp_path, dim, features, seed=dim)
    st = m.state
    up, ip = st["user_rnn"], st["item_rnn"]
    uid, iid, cu, ci = m.scan_inputs(st)
    order, ptr = scan_levels(uid, iid, negs, m.ig.n_users, m.ig.n_items)
    assert len(ptr) - 1 < len(order), "no level holds two events"
    o = torch.from_numpy(order).long()

    def tables():
        ue, ie = st["user_static"].clone(), st["item_static"].clone()
        return [ue, ie, ue.clone(), ie.clone()]

    seq, lev = tables(), tables()
    l_seq = jodie_epoch_ref(*seq, uid, iid, negs, cu, ci, up, ip, 0.05,
                            bce_lr)
    l_lev = jodie_epoch_ref(*lev, uid[o], iid[o], negs[o], cu[o], ci[o], up,
                            ip, 0.05, bce_lr)
    for a, b in zip(lev, seq):
        assert torch.equal(a, b)
    # the loss sums the same terms in another order
    torch.testing.assert_close(l_lev, l_seq, rtol=1e-5, atol=0)


def _epoch_args(tmp_path, seed=3):
    m, negs = _model_inputs(tmp_path, 16, True, seed=seed)
    st = m.state
    uid, iid, cu, ci = m.scan_inputs(st)
    args = (uid, iid, negs, cu, ci, st["user_rnn"], st["item_rnn"], 0.05,
            0.2)
    return m, args


def _tables(m):
    ue, ie = m.state["user_static"].clone(), m.state["item_static"].clone()
    return [ue, ie, ue.clone(), ie.clone()]


def _forged(s: LevelSchedule, how: str) -> LevelSchedule:
    b = s.bounds.copy()
    if how == "short_order":
        return s._replace(order=s.order[:-1])
    if how == "ends_before_T":
        b[-1] -= 1
    elif how == "starts_after_0":
        b[0] = 1
    elif how == "falls":
        b[1], b[2] = b[2], b[1]
    elif how == "ptr_length":
        return s._replace(level_ptr=s.level_ptr[:-1])
    return s._replace(bounds=b)


@pytest.mark.parametrize("how", ["short_order", "ends_before_T",
                                 "starts_after_0", "falls", "ptr_length"])
def test_a_schedule_that_does_not_fit_the_events_raises(tmp_path, how):
    m, args = _epoch_args(tmp_path)
    s = level_schedule(args[0], args[1], args[2], m.ig.n_users,
                       m.ig.n_items, "cpu")
    with pytest.raises(ValueError, match="schedule"):
        jodie_epoch(*_tables(m), *args, _forged(s, how))


def test_the_plain_loop_takes_a_schedule_and_ignores_it(tmp_path):
    m, args = _epoch_args(tmp_path)
    s = level_schedule(args[0], args[1], args[2], m.ig.n_users,
                       m.ig.n_items, "cpu")
    a, b = _tables(m), _tables(m)
    la = jodie_epoch(*a, *args, s)
    lb = jodie_epoch_ref(*b, *args)
    for x, y in zip(a + [la], b + [lb]):
        assert torch.equal(x, y)


def test_the_cpu_epoch_builds_no_schedule(tmp_path, monkeypatch):
    m, args = _epoch_args(tmp_path)

    def refuse(*a, **k):
        raise AssertionError("a schedule was built for the CPU")

    monkeypatch.setattr(jodie_model, "level_schedule", refuse)
    ue, ie, us, is_, loss = m.epoch(m.state, 0.05, 0.2, negs=args[2])
    b = _tables(m)
    lb = jodie_epoch_ref(*b, *args)
    for x, y in zip((ue, ie, us, is_), b):
        assert torch.equal(x, y)
    assert torch.equal(loss, lb / m.ig.n_interactions)
