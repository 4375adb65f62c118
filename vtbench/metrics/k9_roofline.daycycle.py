"""``k9_roofline.daycycle``: K9's least time for the work of one call
(``vtbench/yardstick/k9.py``: the paths, the bounces they take, their
marches at ``fog_steps`` segments, their input and output bytes, the
pack's sectors their casts read) over K9's measured device time a call,
in percent of the published peaks (67 TFLOP/s float32, 3.35 TB/s; the
run's standard error gives the card's power limit). The work is that of
the reference's paths over every pixel of one sample of the checked
frame (``check.k9_work``: the same paths, bit for bit; a call at batch 1
is a sample); no counter of K9 is read."""

import sys

from vtbench import trace
from vtbench.yardstick import k9


def read(run):
    ev, w = run.events, run.counts.get("k9_call")
    if ev is None or ev.window is None or not ev.requests or not w:
        return None
    k9_s = trace.k9_us(ev.in_window(card) for card in ev.cards()) * 1e-6
    if not k9_s:
        return None
    ops_s, bytes_s = k9.times(w["paths"], w["bounces"], w["marches"],
                              run.cfg["film"]["fog_steps"], w["pack_bytes"],
                              k9.LUT_BYTES)
    call_s = k9_s / ev.requests
    print(f"k9_roofline: a call {call_s * 1e3:.4f} ms; least by operations "
          f"{ops_s * 1e3:.4f} ms, by bytes {bytes_s * 1e3:.4f} ms "
          f"({w['pack_bytes']} B of the pack)", file=sys.stderr, flush=True)
    return 100.0 * max(ops_s, bytes_s) / call_s
