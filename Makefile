# Pre-commit gates.
#
# verify      : full pytest suite (CPU, 8 virtual devices, f64) + the
#               multi-device dryrun gate on 8 virtual CPU devices.
# verify-gpu  : the bring-up check on one NVIDIA GPU (chip_smoke.py).

PY := python

.PHONY: verify verify-gpu test test-serial dryrun

verify: test dryrun

test:
	$(PY) scripts/test_shards.py 2

# Single-process fallback (the sharded runner is the default).
test-serial:
	$(PY) -m pytest tests/ -q

dryrun:
	$(PY) -c "import os; \
	os.environ['XLA_FLAGS'] = os.environ.get('XLA_FLAGS','') + ' --xla_force_host_platform_device_count=8'; \
	import jax; jax.config.update('jax_platforms', 'cpu'); \
	import __graft_entry__ as g; g.dryrun_multichip(8); print('dryrun_multichip(8) ok')"

verify-gpu:
	$(PY) chip_smoke.py
