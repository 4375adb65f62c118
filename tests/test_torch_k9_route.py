"""The bounce loop's route (voxtracer_torch/kernels/integrator.py): a call
of ``trace_paths`` on CUDA tensors takes K9 for every combination of its
options (sun maps, the bit grid, edit bounds, bounce 0's primary hits, a
heightfield pack), and never the masked loop ``trace_paths_plain``,
which is K9's plain version and serves CPU tensors; any other device
raises. Held by the pure rule ``route`` (the device alone), K9's engine
``k9_engine`` over every combination, and ``trace_paths`` itself over
every combination with a direction that reports a CUDA device, its two
callees replaced by recorders (no card is needed: the call stops at the
recorder).
"""

import itertools

import pytest
import torch

from voxtracer_torch.kernels import integrator

OPTIONS = ("hf_mips", "hf_edit_bounds", "sun_maps", "bitworld", "primary")
COMBOS = list(itertools.product((False, True), repeat=len(OPTIONS)))


def _kw(combo):
    """A stand-in object for each option that is on (``route`` and the
    recorders only test them against None)."""
    return {name: (object() if on else None)
            for name, on in zip(OPTIONS, combo)}


def _engine(kw):
    if kw["bitworld"] is not None:
        return "bit"
    if kw["hf_mips"] is None:
        return "svo"
    return "edited" if kw["hf_edit_bounds"] is not None else "hf"


def test_route_is_the_device_alone():
    """The rule itself: CUDA takes K9, the CPU the masked loop; another
    device raises."""
    assert integrator.route(torch.device("cuda")) == "k9"
    assert integrator.route("cuda:0") == "k9"
    assert integrator.route(torch.device("cpu")) == "plain"
    with pytest.raises(ValueError):
        integrator.route(torch.device("meta"))


@pytest.mark.parametrize("combo", COMBOS)
def test_k9_engine_is_the_masked_loops_cast(combo):
    """K9's engine for every combination of the options: the bit grid
    before a heightfield pack, the edited heightfield with edit bounds,
    the SVO without a pack (the casts the masked loop takes)."""
    kw = _kw(combo)
    assert integrator.k9_engine(kw["hf_mips"], kw["hf_edit_bounds"],
                                kw["bitworld"]) == _engine(kw)


class _CudaDirection:
    """A direction that reports a CUDA device (trace_paths reads only its
    device before it hands it to K9)."""

    device = torch.device("cuda")


def test_trace_paths_sends_no_cuda_call_to_the_masked_loop(monkeypatch):
    """Every combination of the options, fused or not, on a CUDA
    direction: K9 is called with the options as given, the masked loop
    never."""
    calls = []

    def k9(*args):
        calls.append(args)
        return "k9"

    def plain(*args, **kw):
        raise AssertionError("a CUDA call reached the masked loop")

    monkeypatch.setattr(integrator, "_trace_paths_k9", k9)
    monkeypatch.setattr(integrator, "trace_paths_plain", plain)
    wl = torch.zeros(4)
    for combo in COMBOS:
        kw = _kw(combo)
        for fuse in (False, True):
            out = integrator.trace_paths(None, 0, 5, None, None,
                                         _CudaDirection(), wl, None, None,
                                         primary=kw["primary"],
                                         hf_mips=kw["hf_mips"],
                                         hf_edit_bounds=kw["hf_edit_bounds"],
                                         sun_maps=kw["sun_maps"],
                                         bitworld=kw["bitworld"],
                                         bit_size=128, fuse_nee=fuse)
            assert out == "k9"
            got = calls[-1]
            # the options reach K9 as given; the fused draws only where
            # the JAX package fuses (the unedited heightfield, no maps, no
            # bit grid)
            assert got[11] is kw["primary"] and got[12] is kw["hf_mips"]
            assert got[15] is kw["hf_edit_bounds"]
            assert got[16] is kw["sun_maps"] and got[17] is kw["bitworld"]
            fused = fuse and _engine(kw) == "hf" and kw["sun_maps"] is None
            assert got[-1] == (integrator.PLANET_DRAWS if fused else 0)
    assert len(calls) == 2 * len(COMBOS)


def test_trace_paths_sends_cpu_calls_to_the_masked_loop(monkeypatch):
    """And every CPU call to the masked loop, K9 never."""
    seen = []
    monkeypatch.setattr(integrator, "_trace_paths_k9", lambda *a: 1 / 0)
    monkeypatch.setattr(integrator, "trace_paths_plain",
                        lambda *a, **k: seen.append(a) or "plain")
    d = torch.zeros(4, 3)
    for combo in COMBOS:
        kw = _kw(combo)
        assert integrator.trace_paths(None, 0, 5, None, None, d, d[:, 0],
                                      None, None, **kw) == "plain"
    assert len(seen) == len(COMBOS)
