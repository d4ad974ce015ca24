# `make check` = full CPU suite + GPU smoke run + GPU bench + virtual
# 8-device multi-device dryrun.  `make quick` is the fast inner-loop smoke
# (default-mode BDPT trace + import health) for mid-milestone commits.
# `onchip` and `bench` need an NVIDIA GPU and fail without one.

PY ?= python

.PHONY: check quick test bench dryrun onchip

check: test onchip bench dryrun

test:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -x -q

# The main render path on the card, checked against the plain references.
onchip:
	timeout 1800 $(PY) chip_smoke.py

quick:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_smoke.py -x -q
	$(MAKE) dryrun

bench:
	timeout 900 $(PY) bench.py

dryrun:
	timeout 900 env XLA_FLAGS=--xla_force_host_platform_device_count=8 \
	  JAX_PLATFORMS=cpu $(PY) -c "import __graft_entry__ as g; g.dryrun_multichip(8)"
