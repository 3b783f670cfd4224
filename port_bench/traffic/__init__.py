"""Traffic: the general generators (one module per kind) and the mixes
(one ``.json`` of parameters per mix) that they read."""
