"""The paper's discrete-event SSD model: the event kernel (``events``),
the simulator (``ssd``) and its workloads (``workloads``). Host-side
Python and numpy, the port's own copy of ``repro/core/sim``."""
