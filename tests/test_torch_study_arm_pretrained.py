"""The study's context-restoration arm follows the JAX study's, fold for
fold, on the CPU: one pretraining epoch (8 steps of the patch swap at the
study's dropout 0.1), then 2 folds of 2 fine-tune epochs from those
weights, from seed 42 in both packages (``test_torch_study_parity``'s
``run_arm`` and ``hold_arm``).

Tolerances, measured on the CPU with the port's dropout drawn right and,
for contrast, from another key:
- the first loss to rounding, rtol 1e-4 (measured 5.9e-6; from another
  key 5.2e-3), as the step tests hold a step;
- every loss within rtol 2e-3: rounding grows step by step, as it does
  between two runs of the port at two torch thread counts (4.0e-4 by step
  8); the port against the JAX package 3.0e-4 (from another key 9.7e-3);
- the U-Net's weights within 0.5 of the distance pretraining moved them
  (measured 0.17; from another key 1.21), the BatchNorm statistics within
  0.1 (measured 0.020; from another key 0.21);
- each fold's Dice within 0.01, as the scratch arm's (measured 5e-4)."""

from test_torch_study_parity import hold_arm, run_arm


def test_cr_arm_follows_the_jax_study(tmp_path, monkeypatch):
    run = run_arm("pretrained", tmp_path, monkeypatch)
    hold_arm(run, first_rtol=1e-4, loss_rtol=(2e-3,), weight_ratio=(0.5,), stats_ratio=0.1)
