"""``python -m parfastaai_jax`` == the ``parfastaai-jax`` console script.

Mirrors the reference's single-binary invocation (src/main.cpp:238-272)
for environments where the package is on PYTHONPATH but not installed.
"""

from .cli import main

if __name__ == "__main__":
    main()  # exits via sys.exit with the reference's error codes
