# Developer entry points. See README.md for the full tour.

.PHONY: test oracle asan bench clip demo clean

test:
	python -m pytest tests/ -q

oracle:
	$(MAKE) -C oracle

asan:
	$(MAKE) -C oracle asan

bench: oracle
	python bench.py

clip:
	python tools/encoder.py $${TMPDIR:-/tmp}/demo.h4m --width 320 --height 240 --gops IPBPB,IPP --audio-channels 2

demo:
	python examples/end_to_end.py

clean:
	$(MAKE) -C oracle clean
	rm -f hvqm4_jax/native/_entropy.so
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
