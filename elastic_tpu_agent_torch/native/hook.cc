// elastic-gpu-hook: OCI createRuntime/prestart hook of the CUDA port.
//
// The port's counterpart of the agent's native/hook.cc. The container
// runtime runs it with the OCI hook state on stdin; it loads the bundle's
// config.json, takes the allocation hash from the container env (TPU=<hash>,
// or GPU=<hash> as the elastic scheduler also sets it; TPU wins), and execs
// elastic-gpu-container-toolkit to inject the allocation into the bundle's
// rootfs. No hash in the env: the container is not ours, exit 0.
//
// The hook's own env (set in the hooks.d entry, see install.sh) may name:
//   ELASTIC_GPU_TOOLKIT      the toolkit binary
//                            (default /usr/local/bin/elastic-gpu-container-toolkit)
//   ELASTIC_GPU_ALLOC_DIR    the agent's alloc spec dir (toolkit --alloc-dir)
//   ELASTIC_GPU_DEV_DIR      the host /dev to read (toolkit --dev)
//   ELASTIC_GPU_PROC_ROOT    the host /proc to read (toolkit --proc-root)
//   ELASTIC_GPU_NVIDIA_SMI   the nvidia-smi to ask where /proc hides the
//                            cards' uuids (toolkit --nvidia-smi)
//   ELASTIC_GPU_DRIVER_LIBS  ':'-separated host driver libraries to copy into
//                            an image that lacks them (toolkit --driver-lib)
//   ELASTIC_GPU_HOOK_VERBOSE set: log to stderr (as --verbose)

#include <errno.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

#include <iostream>
#include <sstream>
#include <string>
#include <vector>

#include "json.h"

namespace {

std::string ReadAll(std::istream& in) {
  std::stringstream ss;
  ss << in.rdbuf();
  return ss.str();
}

std::string ReadFile(const std::string& path) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return "";
  std::string out;
  char buf[4096];
  size_t n;
  while ((n = fread(buf, 1, sizeof(buf), f)) > 0) out.append(buf, n);
  fclose(f);
  return out;
}

// "<hash>" of the env entries ["TPU=abc", ...]; TPU wins over GPU, and an
// empty value counts as absent.
std::string HashFromEnv(const egpu::JsonPtr& env_array) {
  std::string gpu_compat;
  if (!env_array || !env_array->is_array()) return "";
  for (auto& e : env_array->items) {
    const std::string& s = e->str_value;
    if (s.rfind("TPU=", 0) == 0 && s.size() > 4) return s.substr(4);
    if (s.rfind("GPU=", 0) == 0 && s.size() > 4 && gpu_compat.empty())
      gpu_compat = s.substr(4);
  }
  return gpu_compat;
}

}  // namespace

int main(int argc, char** argv) {
  bool verbose = getenv("ELASTIC_GPU_HOOK_VERBOSE") != nullptr;
  for (int i = 1; i < argc; i++) {
    if (std::string(argv[i]) == "--verbose") verbose = true;
  }

  // 1. The OCI hook state: {"id": ..., "pid": N, "bundle": DIR}.
  egpu::JsonPtr state = egpu::Json::Parse(ReadAll(std::cin));
  if (!state || !state->is_object()) {
    fprintf(stderr, "elastic-gpu-hook: malformed hook state on stdin\n");
    return 1;
  }
  egpu::JsonPtr bundle_v = state->get("bundle");
  if (!bundle_v) bundle_v = state->get("bundlePath");  // older runtimes
  std::string bundle = bundle_v ? bundle_v->str_or("") : "";
  if (bundle.empty()) {
    fprintf(stderr, "elastic-gpu-hook: hook state has no bundle path\n");
    return 1;
  }

  // 2. The bundle's OCI config: the env and the rootfs.
  egpu::JsonPtr config = egpu::Json::Parse(ReadFile(bundle + "/config.json"));
  if (!config || !config->is_object()) {
    fprintf(stderr, "elastic-gpu-hook: cannot parse %s/config.json\n",
            bundle.c_str());
    return 1;
  }
  egpu::JsonPtr process = config->get("process");
  std::string hash = HashFromEnv(process ? process->get("env") : nullptr);
  if (hash.empty()) {
    if (verbose)
      fprintf(stderr, "elastic-gpu-hook: no TPU/GPU env; passthrough\n");
    return 0;
  }
  egpu::JsonPtr root = config->get("root");
  egpu::JsonPtr root_path = root ? root->get("path") : nullptr;
  std::string rootfs = root_path ? root_path->str_or("rootfs") : "rootfs";
  if (!rootfs.empty() && rootfs[0] != '/') rootfs = bundle + "/" + rootfs;

  // 3. The toolkit injects.
  const char* toolkit = getenv("ELASTIC_GPU_TOOLKIT");
  std::vector<std::string> args = {
      toolkit ? toolkit : "/usr/local/bin/elastic-gpu-container-toolkit",
      "inject", "--rootfs", rootfs, "--hash", hash};
  const struct {
    const char* env;
    const char* flag;
  } passed[] = {{"ELASTIC_GPU_ALLOC_DIR", "--alloc-dir"},
                {"ELASTIC_GPU_DEV_DIR", "--dev"},
                {"ELASTIC_GPU_PROC_ROOT", "--proc-root"},
                {"ELASTIC_GPU_NVIDIA_SMI", "--nvidia-smi"}};
  for (auto& p : passed) {
    const char* v = getenv(p.env);
    if (v && *v) {
      args.push_back(p.flag);
      args.push_back(v);
    }
  }
  if (const char* libs = getenv("ELASTIC_GPU_DRIVER_LIBS")) {
    std::stringstream ss(libs);
    std::string lib;
    while (std::getline(ss, lib, ':')) {
      if (lib.empty()) continue;
      args.push_back("--driver-lib");
      args.push_back(lib);
    }
  }
  if (verbose) args.push_back("--verbose");

  std::vector<char*> cargs;
  for (auto& a : args) cargs.push_back(const_cast<char*>(a.c_str()));
  cargs.push_back(nullptr);
  execv(cargs[0], cargs.data());
  fprintf(stderr, "elastic-gpu-hook: exec %s: %s\n", args[0].c_str(),
          strerror(errno));
  return 1;
}
