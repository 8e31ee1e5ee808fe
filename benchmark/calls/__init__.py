"""The engine calls a traffic mix can drive, one module per call, named as
the mix's "call". Each module has

- `Call(mix)`: `call(engine, request, n) -> (images, product)` drives the
  engine once until its product is on the host (`product` is what the
  check reads besides the keyframes, or None), and `cleanup()` removes
  what the calls left on disk once the check has read it;
- `KEYFRAME_FORMAT`: how the keyframes leave the device ('rgb', or 'i420'
  planes), which the reference replays;
- `NUMBERS`, the check numbers the call adds to the cell's, and
  `judge(dec_pm1, tree, product, mix) -> dict` that reads them (plus any
  "structure" faults; dec_pm1 is the reference's decode of the program's
  final latents in [-1,1], or None where the transition did not replay).
"""
from __future__ import annotations

import importlib


def load(call: str):
    return importlib.import_module(f"benchmark.calls.{call}")
