"""The port's checkpoint codec against flax's files, on the CPU: the port
reads every file the JAX package writes (float32 arrays bitwise,
metadata equal), writes flax's bytes, and its msgpack subset packs as
msgpack-python does."""

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repic_tpu.models import checkpoint as jck
from repic_tpu.models import cnn as jcnn
from repic_tpu_torch.models import checkpoint as tck
from repic_tpu_torch.models import cnn as tcnn
from torch_port_common import t  # noqa: F401  (2 torch threads per worker)

META = {"particle_size": 180, "patch_norm": "reference", "arch": "deep",
        "provenance": {"epochs": 3, "lr": 1e-3, "note": "x" * 40}}


def _params(arch, seed=0):
    return jcnn.PickerCNN(**jcnn.arch_kwargs(arch)).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 1)))["params"]


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", sorted(tcnn.ARCHS))
def test_port_reads_flax_files_bitwise(tmp_path, arch):
    params = _params(arch)
    path = str(tmp_path / "m.ckpt")
    jck.save_checkpoint(path, params, dict(META, arch=arch))
    got, meta = tck.load_checkpoint(path)
    assert meta == dict(META, arch=arch)
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, params)))
    got = dict(_flat(got))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype == np.float32
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("arch", sorted(tcnn.ARCHS))
def test_port_writes_flax_bytes(tmp_path, arch):
    params = _params(arch, seed=3)
    jck.save_checkpoint(str(tmp_path / "j.ckpt"), params, META)
    tck.save_checkpoint(str(tmp_path / "t.ckpt"),
                        jax.tree_util.tree_map(np.asarray, params), META)
    assert (tmp_path / "t.ckpt").read_bytes() == (
        tmp_path / "j.ckpt").read_bytes()
    # and the JAX package reads it back
    back, meta = jck.load_checkpoint(str(tmp_path / "t.ckpt"))
    assert meta == META


def test_bad_magic_raises(tmp_path):
    path = tmp_path / "junk.ckpt"
    path.write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError, match="bad magic"):
        tck.load_checkpoint(str(path))


@pytest.mark.parametrize("arch", sorted(tcnn.ARCHS))
def test_params_from_jax_loads_both_heads(arch):
    params = jax.tree_util.tree_map(np.asarray, _params(arch))
    sd = tck.params_from_jax(params)
    for k, v in sd.items():
        assert v.dtype == torch.float32 and v.is_contiguous(), k
    w = params["backbone"]["conv1"]["kernel"]
    np.testing.assert_array_equal(
        sd["backbone.conv1.weight"].numpy(), w.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["fc1.weight"].numpy(),
                                  params["fc1"]["kernel"].T)
    kw = tcnn.arch_kwargs(arch)
    tcnn.PickerCNN(**kw).load_state_dict(sd, strict=True)
    tcnn.PickerFCN(**kw).load_state_dict(
        tck.params_from_jax(tcnn.fc_params_as_conv(params)), strict=True)


@pytest.mark.parametrize("obj", [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    0.0, -1.5, 1e300, float("inf"), True, False, None,
    "", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 70000, "µ",
    b"", b"x" * 255, b"y" * 256, b"z" * 70000,
    [], [1, "a", None], list(range(15)), list(range(16)),
    list(range(70000)), {}, {"a": 1}, {str(i): i for i in range(16)},
    {"k": {"n": [1, 2.5, b"q"]}},
])
def test_msgpack_subset_matches_msgpack_python(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert tck._pack(obj) == want
    assert tck._unpack(want) == msgpack.unpackb(want, raw=False)


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "uint8",
                                   "bool", "int64"])
def test_array_extension_round_trips(dtype):
    arr = (np.arange(24).reshape(2, 3, 4) % 5).astype(dtype)
    blob = tck._pack({"a": arr, "s": np.float32(1.5)})
    back = tck._unpack(blob)
    np.testing.assert_array_equal(back["a"], arr)
    assert back["a"].dtype == arr.dtype and back["s"] == np.float32(1.5)
    from flax import serialization

    assert serialization.msgpack_serialize({"a": arr}) == tck._pack(
        {"a": arr})
