"""Traffic drivers: each module here runs one kind of load (a mix file in
``mixes/`` names its driver by module name)."""
