"""Tests of the benchmark's yardstick. They import neither JAX nor the JAX
package. `card` marks tests that need an NVIDIA card; they decide inside the
test whether there is one and skip here."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (run on the chip: python3 -m pytest portbench/tests -m card)")
