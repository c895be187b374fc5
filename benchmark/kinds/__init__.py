"""Kinds of traffic.  A traffic file (``benchmark/traffic/<traffic>.json``)
names its ``kind``; ``benchmark/kinds/<kind>.py`` is what that kind does,
found by that name: its frame source, its set-up steps, its unit of work,
its end-to-end values and its compared numbers.  A new kind is a new file
here; a new mix of a kind is a new data file.

Each kind module provides:

- ``SYSTEMS``: the systems (a configuration's ``"system"``) it can drive;
- ``source(run)``: the frame source of the run (see ``harness/drive``);
- ``warm(run)``: set-up's steps, until the window may open;
- ``unit_ends(run)``: whether the last step ended a unit of the window's
  work;
- ``after_step(run)``: work between steps, outside every timed span;
- ``end_to_end(run)``: ``(values, attempted, failed)`` of the window;
- ``readings(run, side, checks)``: every compared number.
"""
