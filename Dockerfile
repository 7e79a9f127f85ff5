# Container for cogaps_tpu — the analog of the reference's
# ghcr.io/fertiglab/cogaps image (reference: Dockerfile, nextflow/main.nf).
# CPU base by default; for NVIDIA GPU hosts install the matching jax[cuda12] wheel.
FROM python:3.12-slim

WORKDIR /opt/cogaps_tpu
COPY pyproject.toml README.md ./
COPY cogaps_tpu ./cogaps_tpu
COPY data ./data

RUN pip install --no-cache-dir "jax[cpu]" optax numpy h5py scipy \
    && pip install --no-cache-dir -e .

ENTRYPOINT ["python", "-m", "cogaps_tpu"]
CMD ["--help"]
