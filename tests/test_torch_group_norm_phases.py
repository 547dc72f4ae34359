"""The phase timing of the one-pass GroupNorm kernels, checked on the CPU:
its summary of the stamps, the stamped build beside the plain one, and the
wrapper's libraries swapped in and back.  The stamps themselves are read
only on a card (``python -m tensorflowonspark_torch.kernels.phases``)."""

import os
import re
import types

import numpy as np
import pytest

from tensorflowonspark_torch.kernels import _build, group_norm, phases


def _stamps(n, k, steps, late=0):
    """Stamps (ns) of n clusters of k blocks: stamp i at sum(steps[:i]) µs,
    cluster j starting ``late * j`` µs after cluster 0."""
    at = np.concatenate([[0], np.cumsum(steps)]) * 1000
    a = np.zeros((n, k, phases.STAMPS), dtype=np.uint64)
    for j in range(n):
        a[j, :, :len(at)] = at + late * j * 1000 + 5_000_000
    return a


@pytest.mark.parametrize("kernel", sorted(phases.PHASES))
def test_summary_gives_each_phase_the_lifetime_and_the_span(kernel):
    names = [p[0] for p in phases.PHASES[kernel]]
    steps = list(range(1, len(names) + 1))
    got = phases.summarize(_stamps(3, 16, steps, late=40), kernel)
    assert list(got)[:len(names)] == names
    for name, step in zip(names, steps):
        assert got[name] == pytest.approx(step)
    assert got["cluster lifetime"] == pytest.approx(sum(steps))
    assert got["span"] == pytest.approx(2 * 40 + sum(steps))


@pytest.mark.parametrize("kernel,source", [("forward", "group_norm"),
                                           ("backward", "group_norm_bwd")])
def test_sources_stamp_every_phase_boundary_once(kernel, source):
    """Each stamp the summary reads is set once in the kernel, only in the
    stamped build, and the build exports the stamps' reader."""
    with open(os.path.join(_build.CSRC_DIR, f"{source}.cu")) as f:
        text = f.read()
    used = [int(i) for i in re.findall(r"PHASE_STAMP\((\d)\);", text)]
    want = {i for _, a, b in phases.PHASES[kernel] for i in (a, b)}
    assert sorted(used) == sorted(want)
    assert f"kStamps = {phases.STAMPS};" in text
    assert f"kStampBlocks = {phases.STAMP_BLOCKS};" in text
    assert f"tfos_gn_{kernel}_phase_stamps" in text
    assert text.count("#ifdef TFOS_GN_PHASE_STAMPS") == 2


def test_stamped_build_is_a_library_of_its_own():
    for name in ("group_norm", "group_norm_bwd"):
        plain = _build.library_path(name)
        stamped = _build.library_path(name, phases.DEFINES)
        assert plain != stamped
        assert os.path.dirname(stamped) == _build.BUILD_DIR
        assert _build.source_hash(name) == _build.source_hash(name, ())
    assert _build._flags(phases.DEFINES)[-1] == "-DTFOS_GN_PHASE_STAMPS"


def test_stamped_kernels_swap_the_libraries_in_and_back(monkeypatch):
    """Inside, the wrapper binds the stamped build and prepares afresh; on
    leaving, its plain libraries and caches are as they were."""
    def fake_lib(tag):
        return types.SimpleNamespace(
            tag=tag, **{f: types.SimpleNamespace() for f in (
                "tfos_group_norm_act_bf16", "tfos_group_norm_one_pass_bf16",
                "tfos_group_norm_one_pass_prepare",
                "tfos_group_norm_bwd_one_pass_bf16",
                "tfos_group_norm_bwd_bf16",
                "tfos_group_norm_bwd_one_pass_prepare")})

    built = []
    monkeypatch.setattr(_build, "build_all",
                        lambda names, defines: built.append((names, defines)))
    monkeypatch.setattr(_build, "load", lambda name, defines=(): fake_lib(
        (name, defines)))
    plain = ("plain forward", "plain backward")
    monkeypatch.setattr(group_norm, "_LIB", plain[0])
    monkeypatch.setattr(group_norm, "_BWD_LIB", plain[1])
    monkeypatch.setattr(group_norm, "_PREPARED", {("Plan", 0, 16, 1)})
    monkeypatch.setattr(group_norm, "_CAPACITY", {("forward", 0): ((9, 9),)})
    with phases.stamped_kernels() as libs:
        assert built == [(("group_norm", "group_norm_bwd"), phases.DEFINES)]
        assert group_norm._LIB[0].__class__ is types.SimpleNamespace
        assert libs["forward"].tag == ("group_norm", phases.DEFINES)
        assert libs["backward"].tag == ("group_norm_bwd", phases.DEFINES)
        assert not group_norm._PREPARED and not group_norm._CAPACITY
    assert (group_norm._LIB, group_norm._BWD_LIB) == plain
    assert group_norm._PREPARED == {("Plan", 0, 16, 1)}
    assert group_norm._CAPACITY == {("forward", 0): ((9, 9),)}


def test_phases_without_a_card_exit_1(capsys):
    assert phases.main([]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err
