"""Tiny ERNIE and ViT training configs for the port's encoder-training
tests (JAX-free: the rank programs import it).

``ernie_yaml`` and ``vit_yaml`` write configs that both packages'
``get_config`` read: the shapes of ``tests/test_ernie.py`` and
``tests/test_vision.py`` (hidden 32, 2 layers, ffn 64; vocab 128 and seq
64 for ERNIE, 32×32 images in patches of 8 and 10 classes for ViT) at 2
heads of 16 (a head dim of the flash kernels), fp32, dp 1 unless
overridden. ``write_ernie_corpus`` writes the token-id files
``ErnieDataset`` reads.
"""

import textwrap

import numpy as np


def write_ernie_corpus(prefix, seed=0, n_docs=40, vocab=120):
    """``{prefix}_ids.npy`` and ``{prefix}_idx.npz``: ``n_docs`` documents
    of 20-60 ids in [4, vocab) (no special id), from a numpy seed."""
    rng = np.random.RandomState(seed)
    docs = [rng.randint(4, vocab, size=rng.randint(20, 60)).astype(np.int32)
            for _ in range(n_docs)]
    np.save(prefix + "_ids.npy", np.concatenate(docs))
    np.savez(prefix + "_idx.npz",
             lens=np.array([len(d) for d in docs], np.int32))


def ernie_yaml(path, prefix, out):
    """A tiny ``ErnieModule`` config over the corpus at ``prefix``."""
    path.write_text(textwrap.dedent(f"""
        Global:
          seed: 7
          local_batch_size: 4
          micro_batch_size: 4
        Engine:
          max_steps: 3
          logging_freq: 1
          eval_freq: 0
          save_load:
            save_steps: 1000
            output_dir: {out}
        Model:
          module: ErnieModule
          right_padded_inputs: True
          vocab_size: 128
          hidden_size: 32
          num_layers: 2
          num_attention_heads: 2
          ffn_hidden_size: 64
          max_position_embeddings: 64
          type_vocab_size: 2
          hidden_dropout_prob: 0.0
          attention_probs_dropout_prob: 0.0
          binary_head: True
        Optimizer:
          name: AdamW
          weight_decay: 0.01
          epsilon: 1.0e-6
          lr:
            name: LinearDecayWithWarmup
            warmup: 1
            total_steps: 100
            max_lr: 1.0e-3
          grad_clip:
            name: ClipGradByGlobalNorm
            clip_norm: 1.0
        Data:
          Train:
            dataset:
              name: ErnieDataset
              input_dir: {prefix}
              max_seq_len: 64
              max_predictions_per_seq: 8
              vocab_size: 128
              num_samples: 100
            sampler:
              name: GPTBatchSampler
              shuffle: True
            loader:
              num_workers: 0
        Distributed:
          dp_degree: 1
        """))
    return str(path)


def vit_yaml(path, out):
    """A tiny ``GeneralClsModule`` config on ``SyntheticClsDataset``, with
    an ``Eval`` split."""
    path.write_text(textwrap.dedent(f"""
        Global:
          seed: 7
          local_batch_size: 8
          micro_batch_size: 8
        Engine:
          max_steps: 3
          logging_freq: 1
          eval_freq: 0
          eval_iters: 2
          save_load:
            save_steps: 1000
            output_dir: {out}
        Model:
          module: GeneralClsModule
          image_size: 32
          patch_size: 8
          num_classes: 10
          hidden_size: 32
          num_layers: 2
          num_attention_heads: 2
          mixup_alpha: 0.0
          label_smoothing: 0.1
          drop_rate: 0.0
          attn_drop_rate: 0.0
          drop_path_rate: 0.0
        Optimizer:
          name: AdamW
          weight_decay: 0.05
          epsilon: 1.0e-6
          lr:
            name: ViTLRScheduler
            learning_rate: 1.0e-3
            epochs: 10
            step_each_epoch: 10
            warmup_epochs: 0
          grad_clip:
            name: ClipGradByGlobalNorm
            clip_norm: 1.0
        Data:
          Train:
            dataset:
              name: SyntheticClsDataset
              image_size: 32
              num_classes: 10
              num_samples: 128
            sampler:
              name: GPTBatchSampler
              shuffle: True
            loader:
              num_workers: 0
          Eval:
            dataset:
              name: SyntheticClsDataset
              image_size: 32
              num_classes: 10
              num_samples: 32
            sampler:
              name: GPTBatchSampler
              shuffle: False
            loader:
              num_workers: 0
        Distributed:
          dp_degree: 1
        """))
    return str(path)
