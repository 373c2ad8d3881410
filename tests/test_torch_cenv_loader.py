"""The port's CEnv loader (procgen2_tpu_torch/tools/cenv_loader.py)
against the JAX package's copy: the ctypes layouts of the reference's C
ABI (cenv/cenv.h), the option array and the key-value reader on values
made here, and the loader's error on a missing library. Driving a real
reference .so is tests/test_torch_reference_execution.py's."""
import ctypes as ct

import numpy as np
import pytest

from procgen2_tpu.tools import cenv_loader as jcl
from procgen2_tpu_torch.tools import cenv_loader as tcl
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STRUCTS = ("_Value", "_Buffer", "_KeyValue", "_Option", "_MakeData",
           "_ResetData", "_StepData", "_RenderData")


@pytest.mark.parametrize("name", STRUCTS)
def test_struct_layouts_match_jax(name):
    j, t = getattr(jcl, name), getattr(tcl, name)
    assert ct.sizeof(t) == ct.sizeof(j) and ct.alignment(t) == ct.alignment(j)
    jf = [(f[0], getattr(j, f[0]).offset, getattr(j, f[0]).size)
          for f in j._fields_]
    tf = [(f[0], getattr(t, f[0]).offset, getattr(t, f[0]).size)
          for f in t._fields_]
    assert jf == tf
    assert [ct.sizeof(f[1]) for f in j._fields_] == [
        ct.sizeof(f[1]) for f in t._fields_]


def test_value_type_tags_match_jax():
    for tag in ("T_INT", "T_FLOAT", "T_DOUBLE", "T_BYTE", "T_BOX",
                "T_MULTI_DISCRETE"):
        assert getattr(tcl, tag) == getattr(jcl, tag)


def test_options_array():
    opts = tcl._options_array({"width": 64, "seed": 7, "scale": 0.25})
    assert len(opts) == 3
    assert [o.name for o in opts] == [b"width", b"seed", b"scale"]
    assert [o.value_type for o in opts] == [tcl.T_INT, tcl.T_INT,
                                            tcl.T_DOUBLE]
    assert (opts[0].value.i, opts[1].value.i, opts[2].value.d) == (64, 7, 0.25)
    assert len(tcl._options_array({})) == 0
    with pytest.raises(TypeError):
        tcl._options_array({"name": "maze"})


@pytest.mark.parametrize("tag,ctype,np_dtype,field", [
    ("T_BYTE", ct.c_uint8, np.uint8, "b"),
    ("T_INT", ct.c_int32, np.int32, "i"),
    ("T_MULTI_DISCRETE", ct.c_int32, np.int32, "i"),
    ("T_FLOAT", ct.c_float, np.float32, "f"),
    ("T_BOX", ct.c_float, np.float32, "f"),
    ("T_DOUBLE", ct.c_double, np.float64, "d")])
def test_read_kv(tag, ctype, np_dtype, field):
    """A key-value of each payload type, read into a copy: the values and
    dtype, the same as the JAX copy reads them; the copy outlives the
    buffer's later writes."""
    vals = np.array([3, 0, 255, 7, 1], np_dtype)
    buf = (ctype * len(vals))(*vals.tolist())
    kv = tcl._KeyValue()
    kv.key = b"obs"
    kv.value_type = getattr(tcl, tag)
    kv.value_buffer_size = len(vals)
    setattr(kv.value_buffer, field, ct.cast(buf, ct.POINTER(ctype)))
    got = tcl._read_kv(kv)
    assert got.dtype == np_dtype
    np.testing.assert_array_equal(got, vals)
    jkv = jcl._KeyValue.from_buffer_copy(kv)
    np.testing.assert_array_equal(jcl._read_kv(jkv), got)
    buf[0] = 9
    assert got[0] == vals[0]


def test_reference_env_on_missing_library_raises(tmp_path):
    with pytest.raises(OSError):
        tcl.ReferenceEnv(str(tmp_path / "ref_missing.so"))
