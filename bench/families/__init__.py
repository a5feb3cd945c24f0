"""Model families: what the harness needs to know of a kind of model,
one module each, ``bench/families/<family>.py``, found by the ``family``
key of a configuration file (``Manifest.family``).  A family module
imports nothing of the port; ``program.py`` imports what it names.  It
provides:

* ``make_params(cfg, seed, device) -> dict``: the seeded weights, made
  on the device, in the form the port's engines and the family's
  reference (``cfg["reference"]``) both take;
* ``PORT_MODULE``, ``PORT_CONFIG`` and ``model_kwargs(cfg) -> dict``:
  the port's model-configuration class and its keyword arguments;
* ``input_dim(cfg) -> int``: the width of the frames the traffic draws;
* ``row_width(cfg) -> int``: the width of the input ``x`` of the
  encoder call that starts a row (one frame of one session);
* ``ops_per_fired(cfg) -> {width: ops}``: operations a fired delta costs
  in the sparse product it feeds, by the width of the input ``x`` of the
  encoder call that fired it;
* ``row_ops(cfg) -> int``: the operations of a row beyond the sparse
  products, counted from shapes.
"""
