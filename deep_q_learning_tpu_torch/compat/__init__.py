"""Host-compatibility path: a host episode loop over Gym-protocol envs
(``compat/host_loop.py``) and the host env adapters (``compat/host_env.py``)."""
