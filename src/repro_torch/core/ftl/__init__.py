"""The paper's map-cache schemes for the SSD model: the calibrated cost
model (``costmodel``) and the DFTL, CDFTL and FMMU caches (``mapcache``).
Host-side Python, the port's own copy of ``repro/core/ftl``."""
