"""The port's checkpointer (``repro_torch.checkpoint``) against the JAX
package's, and the contracts of ``tests/test_checkpoint.py`` on the port.

Both packages write the same layout (``step_<N>/{index.json, shard_0.npz,
COMMIT}``, ``latest``) under the same keys, so a checkpoint written by
either restores in the port.  Every comparison is bitwise: a checkpoint
stores raw buffers.  The JAX package cannot restore a ``bfloat16`` leaf
(its ``restore`` hands the stored ``V2`` words to ``jnp.asarray``; ROADMAP
queue 3), so the port's bf16 words are compared with the JAX tree's
through numpy.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import faults as jf
from repro.checkpoint import checkpointer as jck
from repro.configs import get_reduced as j_get_reduced
from repro.models import model as JM
from repro.parallel.sharding import split_tree
from repro_torch import faults as tf
from repro_torch import tree
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import model as TM

torch.set_num_threads(1)

FIXTURE = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
               vocab_size=128, n_workers=2)


def _tree(seed=0):
    """tests/test_checkpoint.py's tree, as port tensors."""
    rng = np.random.default_rng(seed)
    return {
        "layer": {"w": torch.from_numpy(rng.standard_normal((4, 8)).astype(
            np.float32)),
                  "b": torch.from_numpy(rng.standard_normal((8,)).astype(
                      np.float32))},
        "stack": [torch.from_numpy(rng.standard_normal((3,)).astype(
            np.float32)),
                  torch.from_numpy(rng.integers(0, 5, (2,)).astype(np.int32))],
    }


def _words(t: torch.Tensor) -> np.ndarray:
    """A tensor's raw bits as numpy (bf16 as its uint16 words)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jax_words(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_same(port_tree, want_tree):
    a, b = tree.leaves(port_tree), tree.leaves(want_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(_words(x), _words(y))


# -- the contracts of tests/test_checkpoint.py ------------------------------

def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 7, t, extra={"note": "hello"})
    restored, step, extra = ck.restore(str(tmp_path), template=t)
    assert step == 7 and extra["note"] == "hello"
    _assert_same(restored, t)


def test_latest_points_to_newest_commit(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 5, t)
    ck.save(str(tmp_path), 12, t)
    assert ck.latest_step(str(tmp_path)) == 12


def test_torn_checkpoint_ignored(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 3, t)
    torn = tmp_path / "step_0000000009"          # no COMMIT: a torn write
    torn.mkdir()
    (torn / "index.json").write_text("{}")
    assert ck.latest_step(str(tmp_path)) == 3
    _, step, _ = ck.restore(str(tmp_path), template=t)
    assert step == 3


def test_restore_missing_key_raises(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 1, t)
    bigger = dict(t)
    bigger["extra_param"] = torch.zeros((2,))
    with pytest.raises(KeyError):
        ck.restore(str(tmp_path), template=bigger)


def test_no_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ck.restore(str(tmp_path / "empty"), template={})


# -- the layout, and both packages' files -----------------------------------

def test_layout_matches_jax_package(tmp_path):
    """The same tree saved by both packages: the same files, the same
    index (keys, shapes, dtypes), the same arrays, no temp dir left."""
    t = _tree()
    jt = jax.tree.map(lambda x: jnp.asarray(x.numpy()), t)
    ck.save(str(tmp_path / "port"), 4, t, extra={"a": 1})
    jck.save(str(tmp_path / "jax"), 4, jt, extra={"a": 1})
    for d in ("port", "jax"):
        assert sorted(os.listdir(tmp_path / d)) == ["latest",
                                                    "step_0000000004"]
        assert (tmp_path / d / "latest").read_text() == "4"
        assert sorted(os.listdir(tmp_path / d / "step_0000000004")) == [
            "COMMIT", "index.json", "shard_0.npz"]
    idx = [json.loads((tmp_path / d / "step_0000000004" / "index.json")
                      .read_text()) for d in ("port", "jax")]
    assert idx[0] == idx[1]
    assert idx[0]["keys"] == ["layer/b", "layer/w", "stack/#0", "stack/#1"]
    z = [np.load(tmp_path / d / "step_0000000004" / "shard_0.npz")
         for d in ("port", "jax")]
    for k in idx[0]["keys"]:
        assert z[0][k].dtype == z[1][k].dtype
        assert np.array_equal(z[0][k], z[1][k])


def _mixed_jax_tree():
    rng = np.random.default_rng(3)
    return {
        "f32": jnp.asarray(rng.standard_normal((3, 5)), jnp.float32),
        "bf16": jnp.asarray(rng.standard_normal((7,)) * 40, jnp.bfloat16),
        "i32": [jnp.asarray(rng.integers(-9, 9, (4,)), jnp.int32),
                jnp.int32(17)],
        "mask": jnp.asarray(rng.random(6) < 0.5),
        "aux": jf.FaultState(
            bad=jnp.asarray([True, False, True]),
            offline=jnp.asarray([False, True, False]),
            stale=jnp.asarray(rng.standard_normal((2, 4)), jnp.float32),
            age=jnp.int32(3), consec=jnp.int32(1)),
    }


def _port_template():
    return {"f32": torch.zeros((3, 5)),
            "bf16": torch.zeros((7,), dtype=torch.bfloat16),
            "i32": [torch.zeros((4,), dtype=torch.int32),
                    torch.zeros((), dtype=torch.int32)],
            "mask": torch.zeros((6,), dtype=torch.bool),
            "aux": tf.init_state(3, (2, 4))}


def _flat_jax(jtree):
    return jck._flatten_with_paths(jtree)


def test_jax_checkpoint_restores_in_port_bitwise(tmp_path):
    """f32, int32, bool, bf16 leaves and a FaultState, written by the JAX
    package, come back bit for bit under the port's template."""
    jt = _mixed_jax_tree()
    jck.save(str(tmp_path), 2, jt)
    got, step, _ = ck.restore(str(tmp_path), template=_port_template())
    assert step == 2
    assert isinstance(got["aux"], tf.FaultState)
    flat = ck._flatten_with_paths(got)
    want = _flat_jax(jt)
    assert list(flat) == list(want)        # same keys, JAX's leaf order
    assert "aux/.bad" in flat and "aux/.consec" in flat
    for k, a in want.items():
        t = flat[k]
        assert np.array_equal(_words(t), _jax_words(a)), k
        assert str(np.asarray(a).dtype) == (
            "bfloat16" if t.dtype == torch.bfloat16 else str(t.numpy().dtype))


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port's file restored by the JAX package, bitwise, for the
    non-bf16 leaves; the bf16 leaf's stored words equal the JAX tree's
    (the JAX package's restore cannot take a bf16 leaf at all)."""
    jt = _mixed_jax_tree()
    port = params_from_jax(jax.tree.map(np.asarray, {
        k: v for k, v in jt.items() if k != "aux"}))
    port["aux"] = tf.FaultState(**{
        f: params_from_jax(np.asarray(getattr(jt["aux"], f)))
        for f in ("bad", "offline", "stale", "age", "consec")})
    ck.save(str(tmp_path), 5, port)
    no_bf16 = {k: v for k, v in jt.items() if k != "bf16"}
    got, step, _ = jck.restore(str(tmp_path), template=no_bf16)
    assert step == 5
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(no_bf16)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(np.asarray(a), np.asarray(b))
    idx = json.loads((tmp_path / "step_0000000005" / "index.json")
                     .read_text())
    assert idx["dtypes"]["bf16"] == "bfloat16"
    stored = np.load(tmp_path / "step_0000000005" / "shard_0.npz")["bf16"]
    assert stored.dtype == np.dtype("V2")
    assert np.array_equal(stored.view(np.uint16), _jax_words(jt["bf16"]))


def test_jax_model_checkpoint_serves_in_port(tmp_path):
    """A JAX trainer-style carry of the reduced qwen model (bf16 values,
    float32 master weights) restores into the port's model tree, values
    bitwise ``convert.params_from_jax`` of the same arrays; ``opt: None``
    skips the optimizer state, as the serve launcher restores."""
    jcfg = j_get_reduced("qwen1.5-0.5b", dtype=jnp.bfloat16,
                         param_dtype=jnp.bfloat16, **FIXTURE)
    jv, _ = split_tree(JM.build(jcfg).init(jax.random.PRNGKey(0)))
    master = jax.tree.map(lambda x: x.astype(jnp.float32), jv)
    jck.save(str(tmp_path), 9, {"values": jv, "opt": {"master": master}})
    tm = TM.build(get_reduced("qwen1.5-0.5b", dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16, **FIXTURE))
    template = tm.init(torch.Generator().manual_seed(1))
    got, step, _ = ck.restore(str(tmp_path),
                              template={"values": template, "opt": None})
    assert step == 9 and got["opt"] is None
    _assert_same(got["values"], params_from_jax(jax.tree.map(np.asarray,
                                                             jv)))


def test_restore_places_leaves(tmp_path):
    """``device`` puts every leaf there; without it each leaf goes where
    the template's is (the CPU for a non-tensor leaf)."""
    t = _tree()
    ck.save(str(tmp_path), 1, t)
    got, _, _ = ck.restore(str(tmp_path), template=t, device="cpu")
    assert all(x.device.type == "cpu" for x in tree.leaves(got))
    names = tree.map(lambda x: 0, t)
    got, _, _ = ck.restore(str(tmp_path), template=names)
    _assert_same(got, t)


def test_failed_save_leaves_no_temp_dir(tmp_path):
    class Unsaveable:
        def __array__(self, *a, **k):
            raise RuntimeError("no")

    with pytest.raises(RuntimeError):
        ck.save(str(tmp_path), 1, {"x": Unsaveable()})
    assert os.listdir(tmp_path) == []
    assert ck.latest_step(str(tmp_path)) is None
