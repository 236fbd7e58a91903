"""Test-support subsystems shipped with the package (not the test suite).

``repro_torch.testing.faults`` is the deterministic fault-injection
registry: production modules call ``faults.fire(site)`` at named failure
points, tests arm a site and observe the recovery path.
"""
from repro_torch.testing import faults  # noqa: F401
