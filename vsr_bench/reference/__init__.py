"""The plain references of the benchmark's architectures, one module each,
and what they share (``train.py``: the loss and the optimizer). They import
nothing of the port and take nothing the port made: the benchmark hands a
reference the weights and inputs that it handed the port.

A configuration file names its reference by module (``"reference":
"vsr"`` is ``reference/vsr.py``); ``run.resolve`` imports it and hands it
to the run as ``Run.reference``, and every harness-wide module reaches the
reference through the run. A reference module provides:

- ``param_shapes(model) -> {name: shape}`` for the configuration's
  ``vsr_config.model`` section, named as the port's parameters are named
  (``weights.load`` copies by name), in a fixed order: the weights are
  drawn in that order, so the same seed gives the same weights;
- ``forward(p, model, x, ops=None)``: the architecture's forward in plain
  f32 PyTorch, from the parameters ``p`` on the input ``x`` that the kind
  feeds it (a window of frames, a whole clip, a batch);
- ``Ops(quant=None, record=False)``: its primitive ops. ``quant`` rounds
  the inputs of each op to a lower precision (the control of the
  correctness check); with ``record``, ``.convs`` lists ``(b, h, w, cin,
  cout, f32)`` or ``(b, h, w, cin, cout, f32, k)`` for every conv the
  forward ran (output size, channels, whether the configured model runs it
  in f32, and its square kernel's size, 3 where it is left out), for the
  conv floor;
- optionally ``init_scale(model) -> {name: factor}``: where the
  architecture's published init differs from the harness's seeded draw
  (``weights.make``: LeCun-normal kernels, biases of std 0.01), the
  factors by which ``weights.for_run`` multiplies the named tensors of
  that draw, each beside the published rule it stands for (as BasicSR's
  ``default_init_weights(..., 0.1)``). Every name must be one of
  ``param_shapes``; a reference without it gets the draw unscaled.

The traffic's kind supplies the rest: ``work(run)``, one unit of the cell's
work as a function of an ``Ops``, and how its served outputs are checked.
"""
