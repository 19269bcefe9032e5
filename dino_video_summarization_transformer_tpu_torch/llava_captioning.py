"""Caption generation over adaptively selected frames (ref:
Video-LLaVA/llava_captioning.py:18-111; counterpart of the repo root's
``llava_captioning.py``, with the same flags).

    python -m dino_video_summarization_transformer_tpu_torch.llava_captioning \\
        --loss_file losses.json --data_path /data/msvd --captioner stub

The summarization pipeline's captioning stage: select ``--num_frames``
frames per MSVD clip with the CDF-quantile sampler
(``FrameSelectionDataset``, ``data/selection.py``), decode them
(``data/video.py``), hand them to a video-language captioner and append
``filename "caption</s>"`` rows to ``--output_csv``, which
``captioning_evaluation`` reads. ``--captioner hf`` with ``--model_path``
loads a local HuggingFace video LLM (transformers, imported only there);
``--captioner stub``, or hf without a model path, writes deterministic
placeholder captions, so the pipeline runs offline.
"""

import argparse
import os


def get_args_parser():
    p = argparse.ArgumentParser("Video captioning over selected frames")
    p.add_argument("--cfg", dest="cfg_file", type=str,
                   default="configs/kinetics/timesformer_divst_8x32_224.yaml")
    p.add_argument("--opts", default=None, nargs=argparse.REMAINDER)
    p.add_argument("--data_path", default="", type=str)
    p.add_argument("--loss_file", required=True, type=str)
    p.add_argument("--selection_method", default="adaptive",
                   choices=["adaptive", "uniform"])
    p.add_argument("--num_frames", default=8, type=int)
    p.add_argument("--pre_sampling_rate", default=4, type=int)
    p.add_argument("--output_csv", default="eval_logs/captions_adaptive.csv")
    p.add_argument("--captioner", default="hf", choices=["hf", "stub"])
    p.add_argument("--model_path", default="", type=str,
                   help="local video-LLM checkpoint dir (transformers)")
    p.add_argument("--prompt", default="Describe the video in one sentence.")
    p.add_argument("--limit", default=0, type=int)
    return p


def make_hf_captioner(model_path: str, prompt: str):
    """Local transformers video-LLM (Video-LLaVA / LLaVA-NeXT-Video style).

    Two preprocessing paths:
    * the model dir ships a full processor with a video processor -> use it
      (the published Video-LLaVA layout);
    * otherwise (e.g. environments without torchvision, which transformers'
      video processors require) preprocess manually: run the image
      processor per frame, stack to ``pixel_values_videos``, and expand the
      single ``<video>`` placeholder to the model's per-video token count —
      exactly what the processor would do.
    """
    import torch
    from transformers import AutoProcessor, AutoTokenizer

    try:
        from transformers import VideoLlavaForConditionalGeneration as VLM
    except ImportError:  # older/newer naming
        from transformers import AutoModelForVision2Seq as VLM

    dtype = torch.float16 if torch.cuda.is_available() else torch.float32
    model = VLM.from_pretrained(model_path, torch_dtype=dtype)

    processor = None
    try:
        processor = AutoProcessor.from_pretrained(model_path)
    except Exception as e:
        print(f"full processor unavailable ({e}); using manual video "
              "preprocessing")
    if processor is not None and getattr(processor, "video_processor", None) is None:
        processor = None

    if processor is not None:
        tokenizer = processor.tokenizer

        def preprocess(text, frames):
            return processor(text=text, videos=list(frames),
                             return_tensors="pt")
    else:
        from transformers import AutoImageProcessor

        image_processor = AutoImageProcessor.from_pretrained(model_path)
        tokenizer = AutoTokenizer.from_pretrained(model_path)
        vcfg = model.config.vision_config
        # VideoLlava keeps the CLS token for VIDEO features regardless of
        # the select strategy (modeling_video_llava.get_video_features)
        per_frame = (vcfg.image_size // vcfg.patch_size) ** 2 + 1
        video_token_id = model.config.video_token_index

        def preprocess(text, frames):
            feats = image_processor(images=list(frames), return_tensors="pt")
            # VideoLlava's image processor names its output
            # pixel_values_images; generic ones use pixel_values
            key = ("pixel_values_images" if "pixel_values_images" in feats
                   else "pixel_values")
            pix = feats[key]
            ids = tokenizer(text, return_tensors="pt")["input_ids"][0]
            n_video_tokens = per_frame * len(frames)
            expanded = []
            for tok in ids.tolist():
                expanded.extend([tok] * n_video_tokens
                                if tok == video_token_id else [tok])
            input_ids = torch.tensor([expanded])
            return {
                "input_ids": input_ids,
                "attention_mask": torch.ones_like(input_ids),
                "pixel_values_videos": pix.unsqueeze(0).to(dtype),
            }

    def caption(frames):  # frames (T, H, W, 3) uint8
        text = f"USER: <video>\n{prompt} ASSISTANT:"
        inputs = preprocess(text, frames)
        out = model.generate(**inputs, max_new_tokens=60, do_sample=False)
        decoded = tokenizer.batch_decode(out, skip_special_tokens=True)[0]
        return decoded.split("ASSISTANT:")[-1].strip()

    return caption


def make_stub_captioner(prompt: str):
    def caption(frames):
        t, h, w, _ = frames.shape
        return f"a video with {t} selected frames of size {h}x{w}"

    return caption


def run(args):
    from .config import load_config
    from .data import video as vio
    from .data.datasets import FrameSelectionDataset

    config = load_config(args)
    config.DATASET = "MSVD"
    if args.data_path:
        config.DATA.PATH_TO_DATA_DIR = args.data_path
        if not config.DATA.PATH_PREFIX:
            config.DATA.PATH_PREFIX = args.data_path
    config.LOSS_FILE = args.loss_file

    dataset = FrameSelectionDataset(
        config, pre_sampling_rate=args.pre_sampling_rate,
        selection_method=args.selection_method, num_frames=args.num_frames,
        augmentations=False, return_type="Indices", mode="test")

    if args.captioner == "hf" and args.model_path:
        captioner = make_hf_captioner(args.model_path, args.prompt)
    else:
        if args.captioner == "hf":
            print("WARNING: no --model_path; using the stub captioner")
        captioner = make_stub_captioner(args.prompt)

    os.makedirs(os.path.dirname(args.output_csv) or ".", exist_ok=True)
    n = len(dataset) if not args.limit else min(args.limit, len(dataset))
    for i in range(n):
        indices, _, file_name = dataset[i]
        path = dataset._path_to_videos[i]
        try:
            frames = vio.read_video_indices(path, indices)
        except vio.DecodeError as e:
            print(f"skip {file_name}: {e}")
            continue
        text = captioner(frames)
        # output row format (ref: Video-LLaVA/llava_captioning.py:104-107)
        with open(args.output_csv, "a") as f:
            f.write(f'{file_name} "{text}</s>"\n')
        print(f"{i + 1}/{n} {file_name}: {text}", flush=True)


def main(argv=None):
    run(get_args_parser().parse_args(argv))


if __name__ == "__main__":
    main()
