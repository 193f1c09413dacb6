#!/bin/bash
# GPU VM startup script for the PyTorch/CUDA package: the first boot
# provisions the environment; every later boot resumes the interrupted
# training runs.
#
# The CUDA counterpart of deploy/cloud/tpu_vm_startup.sh (reference
# utils/aws/userdata.sh + mime.sh + resume.py): attach it as the startup
# script of a spot VM with one H100, so that a preempted VM picks up its
# runs where their last checkpoint left them, e.g.
#   gcloud compute instances create $NAME --zone=$ZONE \
#     --machine-type=a3-highgpu-1g --provisioning-model=SPOT \
#     --image-family=common-cu128-ubuntu-2204-nvidia-570 \
#     --image-project=deeplearning-platform-release \
#     --metadata-from-file startup-script=mmidet_tpu_torch/deploy/cloud/gpu_vm_startup.sh \
#     --metadata mmidet-repo-url=https://example.com/you/mmidet_tpu.git
# The image must carry the NVIDIA driver and the CUDA toolkit (nvcc):
# mmidet_tpu_torch/kernels.py builds the kernels at first use.
#
# Training resume is the trainer's own (ckpt/epoch<N>.pt holds the model,
# EMA, optimizer and counts: mmidet_tpu_torch/train/checkpoint.py), so the
# restart is mmidet_tpu_torch.tools.resume_all over the runs directory.
#
# Checked only statically (bash -n, and the module it runs): it has not
# been booted, since the machines this package is developed and tested on
# have no network and no cloud VM.

set -u
cd /home/mmidet 2>/dev/null || { sudo mkdir -p /home/mmidet && cd /home/mmidet; }

# the repo URL comes from the instance metadata (startup scripts get no
# custom environment)
REPO_URL=$(curl -fs -H "Metadata-Flavor: Google" \
  "http://metadata.google.internal/computeMetadata/v1/instance/attributes/mmidet-repo-url" \
  || true)
if [ -z "${REPO_URL}" ]; then
  echo "mmidet-repo-url metadata missing; nothing to provision" >&2
  exit 0
fi

if [ ! -d mmidet_repo ]; then
  echo "First boot: provisioning."
  git clone "${REPO_URL}" mmidet_repo || { echo "clone failed" >&2; exit 1; }
  cd mmidet_repo
  python3 -m pip install --upgrade pip
  python3 -m pip install torch --index-url https://download.pytorch.org/whl/cu128
  python3 -m pip install numpy pyyaml pillow opencv-python-headless
  # the package and its mmidet-torch-* console scripts, without the JAX
  # package's dependencies
  python3 -m pip install --no-deps --no-build-isolation -e .
  # build the kernels once now (nvcc), so that the first run does not wait
  python3 -c "from mmidet_tpu_torch import kernels; kernels.build_all()" \
    || echo "kernel build failed; each run builds them at first use" >&2
  echo "Provisioning done."
else
  echo "Restart: resuming interrupted runs."
  cd mmidet_repo
  # finds runs/**/opt.yaml whose ckpt/epoch<N>.pt is short of the run's
  # epochs and resumes each in place on the card
  nohup python3 -m mmidet_tpu_torch.tools.resume_all runs >resume.log 2>&1 &
fi
