"""The study's global contrastive arm follows the JAX study's, fold for
fold, on the CPU: one epoch of NT-Xent (8 steps of two crop, flip and
blur views at the study's dropout 0.1), then 2 folds of 2 fine-tune
epochs from the encoder, from seed 42 in both packages
(``test_torch_study_parity``'s ``run_arm`` and ``hold_arm``).

Tolerances, measured on the CPU with the port's dropout drawn right and,
for contrast, from another key:
- the first loss to rounding, rtol 1e-4 (measured 1.2e-7; from another
  key 2.1e-3);
- every loss within rtol 1e-3 (measured 7.0e-5; the port against itself
  at two torch thread counts 5.7e-5; from another key 7.0e-3);
- the encoder's weights within 0.3 of the distance pretraining moved them
  (measured 0.053; from another key 1.06), the BatchNorm statistics within
  0.1 (measured 0.0093; from another key 0.29);
- each fold's Dice within 0.01, as the scratch arm's (measured 2.6e-3;
  from another key 0.084)."""

from test_torch_study_parity import hold_arm, run_arm


def test_global_contrastive_arm_follows_the_jax_study(tmp_path, monkeypatch):
    run = run_arm("contrastive", tmp_path, monkeypatch)
    hold_arm(run, first_rtol=1e-4, loss_rtol=(1e-3,), weight_ratio=(0.3,), stats_ratio=0.1)
