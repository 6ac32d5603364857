# mustache-tpu runtime image. The reference ships a conda image that
# compiles hic-straw (Dockerfile:1-8); here the only native piece is our
# own .hic decoder, built at image build time.
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends \
        g++ make zlib1g-dev && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/mustache-tpu
COPY . .

RUN pip install --no-cache-dir "jax[cuda12]" numpy h5py && \
    pip install --no-cache-dir -e . && \
    make -C mustache_tpu/io/native

ENTRYPOINT ["mustache-tpu"]
