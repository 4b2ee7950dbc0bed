"""The reader of ``forward.epilogue_fused_share``: nothing where the
program has no epilogue counter, the share where it has one."""

import sys
import types

import pytest

from portbench import spec

MODULE = "roadsurf_tpu_torch.ops.bias_act"


def test_no_counter_reads_nothing(monkeypatch):
    read = spec.reader("forward.epilogue_fused_share")
    monkeypatch.setitem(sys.modules, MODULE, None)       # no such module
    assert read(None) is None
    monkeypatch.setitem(sys.modules, MODULE, types.ModuleType(MODULE))
    assert read(None) is None                            # no counter


@pytest.mark.parametrize("fused,plain,share", [(3, 1, 75.0), (160, 0, 100.0),
                                               (0, 5, 0.0), (0, 0, None)])
def test_the_share_of_a_faked_counter(monkeypatch, fused, plain, share):
    mod = types.ModuleType(MODULE)
    mod.counts = {"fused": fused, "plain": plain}
    monkeypatch.setitem(sys.modules, MODULE, mod)
    assert spec.reader("forward.epilogue_fused_share")(None) == share
