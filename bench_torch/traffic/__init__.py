"""Traffic: one data file per mix (``<name>.json``) and the one general
generator that reads them (``generate.py``)."""
