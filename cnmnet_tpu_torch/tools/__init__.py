"""The measurement and recipe tools of the port, one module for each script
of the repository's ``tools/`` that drives the JAX package, under the same
name. Each runs as ``python -m cnmnet_tpu_torch.tools.<name>`` and as
``main(argv)`` in a process, on ``cuda`` unless ``--device cpu`` is given;
without a card a run on ``cuda`` raises instead of moving to the CPU.

Timing (on the card):

* ``bench_batched``: frames/s of bench's forward against the batch;
* ``bench_protocols``: 3/5/7 views at several sizes;
* ``step_time_slope``: chain-slope milliseconds of a bf16 train step;
* ``roofline``: FLOPs and bytes of each phase against the card's peaks;
* ``profile_forward``, ``profile_train``: top device ops by total time;
* ``bench_serving``: a Poisson open-loop client through ``MicroBatcher``;
* ``bench_cv``, ``bench_normals``: each kernel against its plain version.

Scale-out (each a ``data x tile`` mesh of rank processes, ``_ranks.run``:
NCCL with one rank a card on CUDA, gloo on the CPU; with
``cnmnet_tpu_torch/entry.py``'s ``dryrun_multichip``):

* ``scaling_sweep``: step time, samples/s and scaling efficiency over mesh
  shapes;
* ``probe_multichip_hlo``: the collectives one sharded step makes, by
  kind, caller and bytes;
* ``bwd_probe``: chain-slope ms/step and GFLOP of 14 train-step variants
  (one process);
* ``verify_step_time``: the train-mode forward alone, then hard-synced
  steps and their losses (one process).

Recipes: ``check_gt_normal``, ``visualize``, ``train_synth``,
``two_stage_recipe``. ``_batch.tiny_batch`` gives every tool its seeded
synthetic inputs. The benchmark itself is ``cnmnet_tpu_torch/bench.py``
(``python -m cnmnet_tpu_torch.cli bench``).

Tools that measure print one JSON object per measured row besides their
text, so that a caller can read the numbers back.
"""
