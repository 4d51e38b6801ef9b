# Convenience targets mirroring the reference's Makefile test surface
# (reference Makefile:43-64): per-module standalone drivers + e2e smoke test.

PY ?= python

.PHONY: test test_flow test_alpha_shapes test_poisson test_raster test_unit smoke bench quality

# end-to-end smoke run on the bundled small carpet scene (synthetic frames,
# since the sample videos are not shipped; reference: `./recon
# tracks/koberec-.yaml -v`, Makefile:43-45)
test:
	rm -f frame*.png
	$(PY) -m meshrecon.cli tracks/koberec-.yaml -v --synthetic sphere -s 4 -n 1 -o test_output.obj

test_unit:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -x -q

# module drivers (reference TEST_BUILD equivalents)
test_flow:
	$(PY) -m meshrecon.flow.driver

test_alpha_shapes:
	mkdir -p test
	/usr/bin/time -f '%e seconds, %M kBytes' $(PY) -m meshrecon.meshing.driver alpha

test_poisson:
	mkdir -p test
	/usr/bin/time -f '%e seconds, %M kBytes' $(PY) -m meshrecon.meshing.driver poisson

test_greedy:
	mkdir -p test
	$(PY) -m meshrecon.meshing.driver greedy

test_raster:
	mkdir -p test
	$(PY) -m meshrecon.raster.driver

# on a GPU: the pipeline once, each kernel against its XLA reference
smoke:
	$(PY) chip_smoke.py

bench:
	$(PY) bench.py

# multi-scene ground-truth quality gate (sphere + plane + still-life
# fixtures with per-scene regression bounds; tools/quality_harness.py)
quality:
	$(PY) tools/quality_harness.py
