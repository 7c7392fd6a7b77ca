"""The testbed: the scene runner and its CLI (``testbed.runner``), the
independent float64 oracle (``testbed.oracle``), the recorder and
renderers (``testbed.viewer``, ``testbed.instanced``) and the live viewer
(``testbed.live``); counterpart of ``wgmath_tpu/testbed``."""
