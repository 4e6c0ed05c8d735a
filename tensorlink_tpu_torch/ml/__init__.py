"""The ML side of the nodes: the worker executor (``worker.py``), the
validator (``validator.py``), the job handle (``module.py``) and the
serving front-ends (``batching.py``)."""
