"""The whole pipeline through the port's CLIs on the CPU: the counterpart of
tests/test_cli_pipeline.py::test_full_pipeline (stages 2-10) and
test_stage0_dense_pretrain (stage 0), on the same toy model and data. The
validation sets must be the JAX CLI's files byte for byte, and the warm-up
model dir must load in both packages."""
import json

import numpy as np
import pytest
import torch

from repconc_tpu.cli import run_gen_valid_set as jax_gen_valid_set
from repconc_tpu.models import auto as jax_auto
from repconc_tpu.models import repconc_model as jax_model
from repconc_tpu_torch.cli import (
    run_customize_dense, run_dense_eval, run_extract_hardneg,
    run_gen_valid_set, run_repconc_eval, run_train_conc, run_train_dense,
    run_train_jpq, run_warmup,
)
from repconc_tpu_torch.models import auto
from repconc_tpu_torch.models.repconc_model import from_pretrained

WORDS = [f"w{i:02d}" for i in range(30)]
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """tests/test_cli_pipeline.py's toy model and dataset files."""
    from transformers import BertConfig, BertModel, BertTokenizerFast

    torch.manual_seed(11)
    root = tmp_path_factory.mktemp("pipeline")
    model_dir = root / "raw_model"
    model_dir.mkdir()
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
    (model_dir / "vocab.txt").write_text("\n".join(vocab))
    BertTokenizerFast(vocab_file=str(model_dir / "vocab.txt")).save_pretrained(
        model_dir)
    cfg = BertConfig(vocab_size=len(vocab), hidden_size=32, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=64,
                     max_position_embeddings=64, pad_token_id=0)
    BertModel(cfg, add_pooling_layer=False).save_pretrained(model_dir)

    data = root / "data"
    data.mkdir()
    rng = np.random.default_rng(5)
    with open(data / "corpus.tsv", "w") as f:
        for i in range(120):
            filler = " ".join(rng.choice(WORDS[15:], size=5))
            f.write(f"d{i}\t{WORDS[i % 15]} {filler}\n")
    with open(data / "queries.tsv", "w") as f:
        for i in range(30):
            f.write(f"q{i}\t{WORDS[i % 15]}\n")
    with open(data / "qrels.txt", "w") as f:
        for i in range(30):
            for j in range(120):
                if j % 15 == i % 15:
                    f.write(f"q{i} 0 d{j} 1\n")
    return root


def _valid_set_args(data, out, mode):
    return (["--input_corpus_path", str(data / "corpus.tsv"),
             "--input_query_path", str(data / "queries.tsv"),
             "--input_qrel_path", str(data / "qrels.txt")] + mode
            + ["--output_corpus_path", str(out / "corpus.tsv"),
               "--output_query_path", str(out / "queries.tsv"),
               "--output_qrel_path", str(out / "qrels.txt")])


def _same_files(a, b):
    for name in ("corpus.tsv", "queries.tsv", "qrels.txt"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_full_pipeline(env):
    root, data = env, env / "data"

    # stage 2: customize
    run_customize_dense.main([
        "--model_name_or_path", str(root / "raw_model"),
        "--similarity_metric", "METRIC_COS", "--pooling", "mean",
        "--output_dir", str(root / "dense_model")])
    cfg = json.load(open(root / "dense_model" / "config.json"))
    assert cfg["pooling"] == "mean" and cfg["similarity_metric"] == "METRIC_COS"

    # stage 3: dense eval, saving the corpus embeddings for the warm-up
    run_dense_eval.main([
        "--model_name_or_path", str(root / "dense_model"),
        "--corpus_path", str(data / "corpus.tsv"),
        "--query_path", str(data / "queries.tsv"),
        "--qrel_path", str(data / "qrels.txt"),
        "--out_corpus_dir", str(root / "dense_out"),
        "--out_query_dir", str(root / "dense_out" / "dev"),
        "--max_seq_length", "32", "--topk", "50",
        "--save_corpus_embed", "--save_query_embed"] + CPU)
    embeds = np.load(root / "dense_out" / "corpus_embeds.npy")
    assert embeds.shape == (120, 32) and embeds.dtype == np.float32
    assert not (root / "dense_out" / "encode_shards").exists()
    dense_metrics = json.load(open(root / "dense_out" / "dev" / "metric.json"))
    assert "MRR@10" in dense_metrics["mrr"]

    # stage 4: the validation set from the dense run, the JAX CLI's bytes
    run = ["--input_run_path", str(root / "dense_out" / "dev" / "run.tsv"),
           "--topk", "10"]
    run_gen_valid_set.main(_valid_set_args(data, root / "valid", run))
    jax_gen_valid_set.main(_valid_set_args(data, root / "valid_jax", run))
    _same_files(root / "valid", root / "valid_jax")

    # stage 5: OPQ warm-up
    run_warmup.main([
        "--model_name_or_path", str(root / "dense_model"),
        "--MCQ_M", "8", "--MCQ_K", "32",
        "--input_corpus_embed_path", str(root / "dense_out" / "corpus_embeds.npy"),
        "--input_corpus_ids_path", str(root / "dense_out" / "corpus_ids.npy"),
        "--output_model_dir", str(root / "warmup_model"),
        "--output_index_dir", str(root / "warmup_index"),
        "--opq_outer_iters", "4", "--opq_pq_iters", "2",
        "--final_pq_iters", "5"] + CPU)
    codes = np.load(root / "warmup_index" / "codes.npy")
    assert codes.shape == (120, 8) and codes.dtype == np.uint8
    np.testing.assert_array_equal(
        np.load(root / "warmup_index" / "corpus_ids.npy"),
        np.load(root / "dense_out" / "corpus_ids.npy"))
    # the model dir loads in both packages, with the same weights
    port = from_pretrained(str(root / "warmup_model"), device="cpu")
    jax_config, jax_params = jax_model.from_pretrained(str(root / "warmup_model"))
    assert jax_config.to_dict() == port.config.to_dict()
    np.testing.assert_array_equal(np.asarray(jax_params["centroids"]),
                                  port.centroids.detach().numpy())
    np.testing.assert_array_equal(
        np.load(root / "warmup_index" / "centroids.npy"),
        port.centroids.detach().numpy())
    R = port.rotation.detach().numpy()
    np.testing.assert_allclose(R @ R.T, np.eye(32), atol=1e-5)
    assert (root / "warmup_model" / "vocab.txt").exists()

    # stage 6: hard negatives from the dense run
    run_extract_hardneg.main([
        "--run_path", str(root / "dense_out" / "dev" / "run.tsv"),
        "--qrel_path", str(data / "qrels.txt"), "--topk", "20",
        "--output_path", str(root / "hardneg.json")])
    assert len(json.load(open(root / "hardneg.json"))) > 0

    # stage 7: stage-1 training from the warm-up model dir
    run_train_conc.main([
        "--model_name_or_path", str(root / "warmup_model"),
        "--output_dir", str(root / "conc_out"),
        "--qrel_path", str(data / "qrels.txt"),
        "--query_path", str(data / "queries.tsv"),
        "--corpus_path", str(data / "corpus.tsv"),
        "--valid_qrel_path", str(root / "valid" / "qrels.txt"),
        "--valid_query_path", str(root / "valid" / "queries.tsv"),
        "--valid_corpus_path", str(root / "valid" / "corpus.tsv"),
        "--max_query_len", "8", "--max_doc_len", "16",
        "--per_device_train_batch_size", "8",
        "--negative", str(root / "hardneg.json"), "--negative_per_query", "2",
        "--learning_rate", "1e-4", "--centroid_learning_rate", "1e-3",
        "--sk_epsilon", "0.05", "--sk_iters", "10",
        "--max_steps", "4", "--logging_steps", "2", "--eval_steps", "4"] + CPU)
    assert (root / "conc_out" / "final" / "params.msgpack").exists()
    assert (root / "conc_out" / "best" / "params.msgpack").exists()

    # stage 8: repconc eval of the trained model
    eval_args = ["--corpus_path", str(data / "corpus.tsv"),
                 "--query_path", str(data / "queries.tsv"),
                 "--qrel_path", str(data / "qrels.txt"),
                 "--out_corpus_dir", str(root / "conc_eval"),
                 "--max_seq_length", "32", "--topk", "20"] + CPU
    run_repconc_eval.main(eval_args + [
        "--model_name_or_path", str(root / "conc_out" / "final"),
        "--out_query_dir", str(root / "conc_eval" / "dev")])
    assert "MRR@10" in json.load(
        open(root / "conc_eval" / "dev" / "metric.json"))["mrr"]

    # stage 9: JPQ against the frozen stage-8 index
    run_train_jpq.main([
        "--model_name_or_path", str(root / "conc_out" / "final"),
        "--index_dir", str(root / "conc_eval"),
        "--qrel_path", str(data / "qrels.txt"),
        "--query_path", str(data / "queries.tsv"),
        "--valid_qrel_path", str(root / "valid" / "qrels.txt"),
        "--valid_query_path", str(root / "valid" / "queries.tsv"),
        "--max_query_len", "8", "--output_dir", str(root / "jpq_out"),
        "--per_device_train_batch_size", "8",
        "--learning_rate", "1e-4", "--centroid_learning_rate", "1e-3",
        "--dynamic_topk_negative", "16",
        "--max_steps", "4", "--logging_steps", "2", "--eval_steps", "4"] + CPU)
    assert (root / "jpq_out" / "final" / "params.msgpack").exists()

    # stage 10: the stage-2 query encoder against the stage-8 doc codes
    run_repconc_eval.main(eval_args + [
        "--doc_encoder_path", str(root / "conc_out" / "final"),
        "--query_encoder_path", str(root / "jpq_out" / "final"),
        "--out_query_dir", str(root / "jpq_eval" / "dev")])
    assert "MRR@10" in json.load(
        open(root / "jpq_eval" / "dev" / "metric.json"))["mrr"]


def test_stage0_dense_pretrain(env):
    """Stage 0: the run-free validation set (the JAX CLI's bytes), dense
    pre-training with validation, and the HF export: the export must load
    in both packages with the trained encoder's weights, bit for bit."""
    root, data = env, env / "data"
    sample = ["--random_sample", "40"]
    run_gen_valid_set.main(_valid_set_args(data, root / "valid0", sample))
    jax_gen_valid_set.main(_valid_set_args(data, root / "valid0_jax", sample))
    _same_files(root / "valid0", root / "valid0_jax")
    lines = (root / "valid0" / "corpus.tsv").read_text().splitlines()
    assert 40 <= len(lines) <= 120

    out = run_train_dense.main([
        "--model_name_or_path", str(root / "raw_model"),
        "--output_dir", str(root / "dense_pretrain"),
        "--pooling", "mean", "--similarity_metric", "METRIC_IP",
        "--qrel_path", str(data / "qrels.txt"),
        "--query_path", str(data / "queries.tsv"),
        "--corpus_path", str(data / "corpus.tsv"),
        "--valid_qrel_path", str(root / "valid0" / "qrels.txt"),
        "--valid_query_path", str(root / "valid0" / "queries.tsv"),
        "--valid_corpus_path", str(root / "valid0" / "corpus.tsv"),
        "--max_query_len", "8", "--max_doc_len", "16",
        "--per_device_train_batch_size", "8",
        "--learning_rate", "1e-4", "--warmup_steps", "2",
        "--max_steps", "4", "--logging_steps", "2", "--eval_steps", "4"] + CPU)
    assert out["step"] == 4 and 0.0 <= out["best_metric"] <= 1.0
    export = root / "dense_pretrain" / "export_hf"
    for name in ("model.safetensors", "config.json", "vocab.txt"):
        assert (export / name).exists(), name
    assert json.load(open(export / "config.json"))["pooling"] == "mean"

    trained = from_pretrained(str(root / "dense_pretrain" / "best"),
                              device="cpu").encoder.state_dict()
    _, port_state, metric = auto.load_dense_encoder(str(export), device="cpu")
    assert metric == "METRIC_IP"
    assert set(port_state) == set(trained)
    for name, t in trained.items():
        assert torch.equal(port_state[name], t), name
    enc_cfg, jax_params, _ = jax_auto.load_dense_encoder(str(export))
    from repconc_tpu_torch.models.convert import encoder_state_dict

    for name, v in encoder_state_dict(jax_params,
                                      enc_cfg.num_hidden_layers).items():
        np.testing.assert_array_equal(v, trained[name].numpy(), err_msg=name)
