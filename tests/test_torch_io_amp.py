"""``io`` and ``amp`` of paddle_tpu_torch against paddle_tpu's (CPU).

- DataLoader: the same batches in the same order as the JAX package's,
  exact, wherever its samplers draw from numpy (a seeded
  ``DistributedBatchSampler`` shuffle, ``random_split``); batching, drop
  last, iterable datasets and the prefetch thread as ``tests/test_io_amp.py``.
- AMP: the dtype of every op under O1 and O2 equal to the JAX package's
  (its values within 2^-7 of the reference's magnitude: one bf16 rounding
  of the inputs), ``decorate``'s parameter dtypes, and the ``GradScaler``
  scale sequence, exact, on the same inf pattern (the SGD parameters
  beside it within rtol 1e-6: XLA fuses ``p - lr g`` into one rounding).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.framework import device as tp_device

BF16_RTOL = 2.0 ** -7


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tp_device._CURRENT
    tp.set_device("cpu")
    yield
    tp.set_device(prev)


def _np(x):
    if isinstance(x, tp.Tensor):
        return x.numpy(), str(x.dtype).replace("torch.", "")
    arr = np.asarray(x._data)
    name = np.dtype(arr.dtype).name
    return (arr.astype(np.float32) if name == "bfloat16" else arr), name


def _batches(loader):
    out = []
    for b in loader:
        b = b if isinstance(b, (list, tuple)) else [b]
        out.append([_np(t) for t in b])
    return out


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for gb, wb in zip(got, want):
        for (g, gd), (w, wd) in zip(gb, wb):
            assert gd == wd
            np.testing.assert_array_equal(g, w)


def _squares(P, n=20):
    class Squares(P.io.Dataset):
        def __getitem__(self, i):
            return np.float32([i]), np.float32([i * i])

        def __len__(self):
            return n

    return Squares()


@pytest.mark.parametrize("kw", [dict(batch_size=8), dict(batch_size=8, drop_last=True),
                                dict(batch_size=4, num_workers=2)],
                         ids=["batching", "drop_last", "prefetch_thread"])
def test_dataloader_batches_match_jax(kw):
    got = _batches(tp.io.DataLoader(_squares(tp), **kw))
    want = _batches(jp.io.DataLoader(_squares(jp), **kw))
    _assert_same_batches(got, want)


@pytest.mark.parametrize("epoch", [0, 3])
def test_seeded_distributed_shuffle_gives_the_jax_order(epoch):
    out = []
    for P in (tp, jp):
        P.seed(11)
        ids = P.to_tensor(np.arange(40, dtype=np.int32).reshape(20, 2))
        ds = P.io.TensorDataset([ids, P.to_tensor(np.arange(20, dtype=np.float32))])
        batches = []
        for rank in (0, 1):
            sampler = P.io.DistributedBatchSampler(ds, batch_size=3, num_replicas=2, rank=rank,
                                                   shuffle=True)
            sampler.set_epoch(epoch)
            batches += _batches(P.io.DataLoader(ds, batch_sampler=sampler))
        out.append(batches)
    _assert_same_batches(*out)


def test_random_split_and_shuffled_loader():
    splits = []
    for P in (tp, jp):
        P.seed(5)
        a, b = P.io.random_split(_squares(P), [14, 6])
        splits.append((a.indices, b.indices))
        dl = P.io.DataLoader(_squares(P), batch_size=8, shuffle=True, drop_last=True)
        vals = np.concatenate([np.asarray(bt[0]).reshape(-1) for bt in dl])
        assert len(vals) == 16 and len(set(vals.tolist())) == 16
    assert splits[0] == splits[1]


@pytest.mark.parametrize("kw", [dict(worker_init_fn=lambda i: None), dict(timeout=5),
                                dict(shm_slot_bytes=1 << 20)])
def test_worker_process_options_raise_where_workers_would_take_them(kw):
    """The JAX package hands these to its worker processes; the port has
    none (``num_workers > 0`` prefetches on a thread), so it refuses them
    there and takes them, as the JAX package does, without workers."""
    with pytest.raises(NotImplementedError):
        tp.io.DataLoader(_squares(tp), batch_size=8, num_workers=2, **kw)
    got = _batches(tp.io.DataLoader(_squares(tp), batch_size=8, **kw))
    _assert_same_batches(got, _batches(jp.io.DataLoader(_squares(jp), batch_size=8, **kw)))
    assert tp.io.get_worker_info() is None


def test_iterable_dataset_and_dict_samples():
    for P in (tp, jp):
        class Stream(P.io.IterableDataset):
            def __iter__(self):
                for i in range(10):
                    yield np.float32([i])

        batches = list(P.io.DataLoader(Stream(), batch_size=4))
        assert [b.shape for b in batches] == [[4, 1], [4, 1], [2, 1]]
    dicts = [{"x": np.int64(i), "y": [np.float32(i), "s"]} for i in range(3)]
    got, want = tp.io.default_collate_fn(dicts), jp.io.default_collate_fn(dicts)
    assert _np(got["x"]) [1] == _np(want["x"])[1] == "int32"
    assert got["y"][1] == want["y"][1] == ["s", "s", "s"]


X = np.random.default_rng(3).standard_normal((4, 8)).astype(np.float32)
W = np.random.default_rng(4).standard_normal((8, 8)).astype(np.float32)


def _amp_ops(P):
    F = P.nn.functional
    x, w = P.to_tensor(X), P.to_tensor(W)
    out = P.matmul(x, w)
    return [out, F.linear(x, w), F.softmax(out), P.exp(x * 0.1), P.add(x, x), P.mean(x),
            P.reshape(x, [8, 4]), F.relu(x), F.gelu(x), F.layer_norm(x, [8]),
            F.cross_entropy(x, P.to_tensor(np.array([1, 2, 3, 0], np.int32))),
            P.einsum("ij,jk->ik", x, w), P.sum(x, axis=1), P.tanh(x), P.bmm(x[None], w[None]),
            F.log_softmax(x), F.sigmoid(x), P.sqrt(P.abs(x))]


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_auto_cast_op_dtypes_match_jax(level):
    outs = []
    for P in (tp, jp):
        with P.amp.auto_cast(level=level, dtype="bfloat16"):
            outs.append([_np(o) for o in _amp_ops(P)])
        assert not P.amp.is_auto_cast_enabled()
    for k, ((g, gd), (w, wd)) in enumerate(zip(*outs)):
        assert gd == wd, f"op {k}: {gd} != {wd}"
        np.testing.assert_allclose(g, w, rtol=BF16_RTOL,
                                   atol=BF16_RTOL * max(1.0, float(np.abs(w).max())),
                                   err_msg=f"op {k}")
    # and off again: fp32 throughout
    assert _np(tp.matmul(tp.to_tensor(X), tp.to_tensor(W)))[1] == "float32"


def test_custom_lists_and_nesting_restore_the_outer_policy():
    for P in (tp, jp):
        x = P.to_tensor(X)
        with P.amp.auto_cast(custom_white_list={"tanh"}):
            assert _np(P.tanh(x))[1] == "bfloat16"
            with P.amp.auto_cast(custom_black_list={"matmul"}):
                assert _np(P.matmul(x, x.T))[1] == "float32"
            assert _np(P.tanh(x))[1] == "bfloat16"
            assert _np(P.matmul(x, x.T))[1] == "bfloat16"


def test_decorate_o2_casts_all_but_norms():
    dtypes = []
    for P, kw in ((tp, dict(device="cpu")), (jp, {})):
        nn = P.nn
        m = nn.Sequential(nn.Linear(4, 4, **kw), nn.LayerNorm(4, **kw))
        m = P.amp.decorate(m, level="O2", dtype="bfloat16")
        dtypes.append([str(p.dtype).replace("torch.", "") for _, p in m.named_parameters()])
    assert dtypes[0] == dtypes[1] == ["bfloat16", "bfloat16", "float32", "float32"]


# 1 = a finite step, 0 = a step whose gradient holds an inf
PATTERN = [1, 1, 0, 1, 1, 1, 0, 0, 1, 1, 1]


def _scaler_run(P, Param):
    w = Param(np.array([1.0, -2.0], np.float32))
    opt = P.optimizer.SGD(learning_rate=0.1, parameters=[w])
    scaler = P.amp.GradScaler(init_loss_scaling=8.0, incr_every_n_steps=2,
                              decr_every_n_nan_or_inf=1)
    scales, params = [], []
    for ok in PATTERN:
        k = P.to_tensor(np.array([3.0, 1.0 if ok else np.inf], np.float32))
        loss = (w * k).sum()
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        scales.append(float(np.asarray(scaler.get_loss_scaling().numpy())))
        params.append(np.asarray(w.numpy()).copy())
    return scales, params


def test_grad_scaler_sequence_matches_jax():
    (gs, gp), (ws, wp) = _scaler_run(tp, tp.Parameter), _scaler_run(jp, jp.Parameter)
    assert gs == ws
    assert gs[:3] == [8.0, 16.0, 8.0]
    for g, w in zip(gp, wp):
        np.testing.assert_allclose(g, w, rtol=1e-6)


def test_grad_scaler_disabled_passes_through_and_guards_double_unscale():
    scaler = tp.amp.GradScaler(enable=False)
    t = tp.to_tensor([2.0])
    assert scaler.scale(t) is t
    w = tp.Parameter(np.array([1.0], np.float32))
    opt = tp.optimizer.SGD(learning_rate=0.1, parameters=[w])
    s = tp.amp.GradScaler(init_loss_scaling=4.0)
    s.scale((w * 2).sum()).backward()
    s.unscale_(opt)
    with pytest.raises(RuntimeError):
        s.unscale_(opt)
    s.step(opt)
    np.testing.assert_allclose(w.numpy(), [0.8], rtol=1e-6)
    assert isinstance(opt._parameter_list[0], torch.nn.Parameter)
