"""Native (C++) components of the port, built with g++ at first use into
``mppi_tf_tpu_torch/_build/``: the f64 MPPI core (``core.py``, the golden
model) over ``src/mppi_core.cpp``; the replay datastore's source
``src/datastore.cpp`` is bound by ``learning/datastore.py``."""
