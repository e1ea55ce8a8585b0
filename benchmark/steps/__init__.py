"""Step kinds: ``steps/<kind>.py`` makes a traffic mix's inputs and steps.

A mix (``traffic/<mix>.json``) is data; its ``step`` key names the kind that
reads it, as a configuration's ``matrix.kind`` names the module that makes
its matrix.  A kind is a module with

* ``make_inputs(cell, seed)``: the inputs, the same for the same seed;
* ``make_system(factory, inputs, cell, device)``: the system under test
  (``factory`` is ``harness.ProgramSystem`` or the control in its place);
* ``prepare(system, inputs, mix)``: what the steps feed the system;
* ``window(system, feed, mix, seconds, seed, first_step=0, spans=False,
  steps=None)``: the closed loop of steps, a ``harness.Window``;
* ``check(inputs, sample, device, limits, failed)``: each number compared,
  beside its limit.
"""
